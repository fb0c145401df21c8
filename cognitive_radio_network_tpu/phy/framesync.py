"""OFDM frame synchronizer — the ``ofdmflexframesync`` capability, batched.

liquid's synchronizer is a per-sample adaptive state machine (AGC, squelch,
timing PLL) driven inside ``ECR_rx_worker``'s hot loop
(src/extensible_cognitive_radio.cpp:1299-1366).  The design here is
block-oriented and batched instead:

* **detect**: Schmidl&Cox autocorrelation metric over a whole IQ block at
  once (vectorized correlation) finds S0 preambles, refines timing with a
  CFO-corrected matched filter, and estimates CFO from the autocorrelation
  phase;
* **demod**: CP strip, FFT across all symbols at once, one-shot channel
  estimate from S1, per-symbol pilot common-phase tracking, equalize,
  min-distance demod — one fused graph per (config, num_symbols);
* **adaptive receive**: like liquid, the payload's (length, mod, fec, crc)
  ride in the coded PHY header, so :class:`StreamReceiver` first demods the
  fixed-size header region, then dispatches to a cached demod graph for that
  payload configuration;
* **decode** (in-graph): FEC (table codes as gathers, Viterbi as a
  lax.scan) + CRC (table-scan) run batched on-device inside the same rx
  graph, emitting a :class:`FrameSyncStats` record with the fields of the
  vendored framesyncstats contract (framesyncstats.c:39-55).

Streaming state across block boundaries (a frame straddling two blocks) is
carried by the receiver's residual buffer — overlap-save at the frame scale.

Dispatch discipline (the rx path replaces the reference's per-sample hot
loop, src/extensible_cognitive_radio.cpp:1299-1366, so it must be
batch-efficient): :meth:`StreamReceiver.process` issues O(1) device
dispatches per block — one fused scan (top-K Schmidl&Cox detection + header
demod + header FEC/CRC decode for all K candidates at once) plus one fused
demod+decode per distinct payload configuration present in the block
(usually one).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.phy import crc as crc_mod
from cognitive_radio_network_tpu.phy import fec as fec_mod
from cognitive_radio_network_tpu.phy import modem
from cognitive_radio_network_tpu.phy.framegen import (
    HEADER_BYTES,
    TOTAL_HEADER_BYTES,
    _HEADER_CRC,
    _HEADER_FEC,
    _HEADER_MOD,
    OFDMFrameConfig,
    OFDMFrameGen,
    gen_for,
    pack_phy_header,
    unpack_phy_header,
)
from cognitive_radio_network_tpu.signal.iq import split_iq

__all__ = ["FrameSyncStats", "OFDMFrameSync", "StreamReceiver"]


@dataclasses.dataclass
class FrameSyncStats:
    """Per-frame receive statistics (framesyncstats.c:39-55 contract)."""

    evm: float  # error vector magnitude [dB]
    rssi: float  # received signal strength [dB]
    cfo: float  # carrier frequency offset [rad/sample]
    num_framesyms: int
    mod_scheme: str
    mod_bps: int
    check: str
    fec0: str
    fec1: str
    header_valid: bool
    payload_valid: bool


class OFDMFrameSync:
    """Fixed-configuration synchronizer (both sides share the frame config).

    Instances are CHEAP: the generator and every jitted graph come from
    process-wide caches keyed on (config, payload_len), so N identically
    configured radios (up to the reference's 48-node cap,
    include/crts.hpp:189) share one compilation of each rx graph."""

    def __init__(self, cfg: OFDMFrameConfig, payload_len: int):
        self.cfg = cfg
        self.payload_len = payload_len
        self.gen = gen_for(cfg, payload_len)  # shares sizing/preambles
        self._rx = _rx_jit_for(cfg, payload_len)
        self._rx_at = _rx_at_jit_for(cfg, payload_len)

    # -- detection ------------------------------------------------------

    def detect(self, iq, threshold: float = 0.5):
        """Returns (peak_metric, best_offset, cfo)."""
        return _detect(self.gen, iq)

    # -- aligned demodulation ------------------------------------------

    def _stats_from(self, out: dict, i: int) -> FrameSyncStats:
        g = self.gen
        return FrameSyncStats(
            evm=float(out["evm_db"][i]),
            rssi=float(out["rssi_db"][i]),
            cfo=float(out["cfo"][i]),
            num_framesyms=g.num_symbols,
            mod_scheme=self.cfg.mod_scheme,
            mod_bps=g.bps,
            check=self.cfg.crc_scheme,
            fec0=self.cfg.fec0,
            fec1=self.cfg.fec1,
            header_valid=bool(out["hdr_ok"][i]),
            payload_valid=bool(out["pay_ok"][i]),
        )

    def demod_aligned(self, iq, cfo=None):
        """Frame-aligned IQ (B, frame_len) [complex or planes] -> decoded.

        Returns (stats list[FrameSyncStats], headers (B,8), payloads (B,P)).
        ONE device dispatch: demod + FEC + CRC run fused in-graph.
        """
        re, im = split_iq(iq)
        if re.ndim == 1:
            re, im = re[None], im[None]
        b = re.shape[0]
        cfo_arr = (
            jnp.zeros((b,), jnp.float32)
            if cfo is None
            else jnp.asarray(cfo, jnp.float32).reshape(b)
        )
        out = {k: np.asarray(v) for k, v in self._rx(re, im, cfo_arr).items()}
        stats = [self._stats_from(out, i) for i in range(b)]
        return stats, out["headers"], out["payloads"]

    def decode_at(self, rr, ri, offsets, cfos) -> dict:
        """Batched gather+demod+decode at dynamic frame offsets.

        rr/ri: (N,) device planes; offsets/cfos: (G,).  Returns the rx dict
        (device arrays).  One dispatch; used by :class:`StreamReceiver`."""
        return self._rx_at(rr, ri, jnp.asarray(offsets, jnp.int32), jnp.asarray(cfos, jnp.float32))

    def rx_block_fn(self, k: int = 16):
        """Jitted ONE-dispatch fixed-config block receiver for up to ``k``
        frames: (rr, ri, n_valid) -> (bests, peaks, cfos, rx dict, ok).
        Device-level (no host fetch), so calls pipeline — the full-rate rx
        path for benches and the sharded link."""
        return _rx_block_jit_for(self.cfg, self.payload_len, k)

    def receive_block(self, iq, threshold: float = 0.2, k: int = 16):
        """Host convenience over :meth:`rx_block_fn`: returns the frames
        decoded from one block as a list of {offset, stats, header, payload},
        sorted by offset, duplicates/overlaps suppressed."""
        re_np, im_np = _to_np_planes(iq)
        n = re_np.shape[0]
        bests, peaks, cfos, out, ok = self.rx_block_fn(k)(
            jnp.asarray(re_np), jnp.asarray(im_np), jnp.int32(n)
        )
        bests, peaks = np.asarray(bests), np.asarray(peaks)
        ok = np.asarray(ok)
        out = {kk: np.asarray(v) for kk, v in out.items()}
        frames, consumed_end = [], 0
        for i in np.argsort(bests, kind="stable"):
            off = int(bests[i])
            if peaks[i] < threshold or not ok[i] or off < consumed_end:
                continue
            frames.append(
                {
                    "offset": off,
                    "stats": self._stats_from(out, int(i)),
                    "header": out["headers"][i],
                    "payload": out["payloads"][i],
                }
            )
            consumed_end = off + self.gen.frame_len
        return frames

    def receive(self, iq, threshold: float = 0.2):
        """Detect + demod the first frame in a block (fixed config).

        Planes/planar in, planes through: no complex64 ever crosses a jit
        or transfer boundary (portability, see signal/iq.py)."""
        re_np, im_np = _to_np_planes(iq)
        peak, best, cfo = _detect(self.gen, (re_np, im_np))
        best = int(best)
        if float(peak) < threshold:
            return None, None, None, None
        fl = self.gen.frame_len
        if best + fl > re_np.shape[0]:
            return None, None, None, None
        frame = (re_np[None, best : best + fl], im_np[None, best : best + fl])
        stats, hdr, pay = self.demod_aligned(frame, cfo=jnp.asarray([cfo]))
        return best, stats[0], hdr[0], pay[0]


# ----------------------------------------------------------------------
# shared device graphs
# ----------------------------------------------------------------------


def _box3h(x: jax.Array, h: int) -> jax.Array:
    """Sliding sum of width 3h: ``y[t] = sum(x[t : t + 3h])``.

    For power-of-two h this is a doubling ladder (log2 h shifted adds) plus
    a 3-term combine — all data-parallel elementwise passes XLA fuses,
    versus a global cumsum's ~log2(N) full-array dependency chain (the
    S&C metric's dominant cost at block scale, measured ~1 GS/s ceiling).
    Tree-structured adds also avoid the cumsum-difference cancellation."""
    if h & (h - 1):  # non-power-of-two: cumsum difference fallback
        c = jnp.cumsum(jnp.concatenate([jnp.zeros(1, x.dtype), x]))
        return c[3 * h :] - c[: -3 * h]
    s = x
    k = 1
    while k < h:
        s = s[:-k] + s[k:]
        k *= 2
    return s[: s.shape[0] - 2 * h] + s[h : s.shape[0] - h] + s[2 * h :]


def _sc_metric(r: jax.Array, n_valid: jax.Array, m: int):
    """Schmidl&Cox plateau metric over a whole block.

    Returns (metric (N-ish,), p (autocorrelation sums), half).  Normalized
    by the energy of BOTH halves of the correlation window — one-sided
    normalization explodes when the early half is pure noise."""
    half = m // 2
    lag = r[half:] * jnp.conj(r[:-half])
    win = 2 * m - half  # == 3 * half
    p = _box3h(lag, half)
    pw = jnp.abs(r) ** 2
    s3 = _box3h(pw, half)  # s3[t] = sum(pw[t : t + win])
    ln = p.shape[0]
    e1 = s3[:ln]
    e2 = s3[half : half + ln]
    # floor the energies at a fraction of the block's average window energy:
    # without it the ratio spikes at silence->signal boundaries (0/0)
    floor = 0.05 * win * jnp.sum(pw) / jnp.maximum(n_valid, 1) + 1e-20
    metric = jnp.abs(p) ** 2 / (jnp.maximum(e1, floor) * jnp.maximum(e2, floor))
    # mask positions whose correlation window reaches past the valid samples
    idx = jnp.arange(metric.shape[0])
    metric = jnp.where(idx <= n_valid - (win + half), metric, -1.0)
    return metric, p, half


def _refine(rr, ri, metric, p, half, coarses, tmpl, n_valid, m, cp=None):
    """CFO-corrected matched-filter timing refinement, vectorized over K
    coarse candidates.  The S&C metric plateaus (|P| and R shrink together
    during partial overlap), so snap to the known 2x-S0 template.

    Window extraction is ONE contiguous-row gather (extract_windows)
    followed by static slicing — never a fancy-index gather of every
    sample."""
    from cognitive_radio_network_tpu.ops.extract import extract_windows

    tlen = tmpl.shape[0]
    # the box-smoothed S&C plateau maximum sits within ~cp + half of the
    # true start, so cp + m covers it with >= m/2 slack for any cp — the
    # previous blanket +-2m nearly doubled the refinement einsum (the
    # scan's dominant FLOPs at radio block sizes) whenever cp < m
    span = (cp if cp is not None else m) + m
    s_count = 2 * span + 1
    wlen = s_count - 1 + tlen
    cfo0 = jnp.angle(p[jnp.clip(coarses, 0, p.shape[0] - 1)]) / half  # (K,)
    rot = jnp.exp(
        -1j * cfo0[:, None] * jnp.arange(tlen)[None, :].astype(jnp.float32)
    )
    base = jnp.clip(coarses - span, 0, max(rr.shape[0] - wlen, 0))
    wr, wi = extract_windows(rr, ri, base, wlen)  # (K, wlen) each
    w = wr + 1j * wi
    wins = jnp.stack(
        [w[:, s : s + tlen] for s in range(s_count)], axis=1
    )  # (K, S, tlen)
    q = rot * jnp.conj(tmpl)[None, :]
    xc = jnp.abs(jnp.einsum("ksj,kj->ks", wins, q)) ** 2
    we = jnp.sum(jnp.abs(wins) ** 2, axis=-1)
    fine = jnp.argmax(xc / jnp.maximum(we, 1e-12), axis=-1)
    best = base + fine
    cfo = jnp.angle(p[jnp.clip(best, 0, p.shape[0] - 1)]) / half
    peak = metric[jnp.clip(best, 0, metric.shape[0] - 1)]
    return best, peak, cfo


def _detect_core(rr: jax.Array, ri: jax.Array, n_valid: jax.Array,
                 tmpl_r: np.ndarray, tmpl_i: np.ndarray, m: int):
    """S&C coarse detect + matched-filter fine timing (jittable core).

    rr/ri: float32 planes (N,) zero-padded; n_valid: true length (dynamic
    scalar, so one compilation serves every block of the same padded bucket
    size).  Complex is formed INSIDE the graph; the template arrives as two
    numpy real constants (complex device constants cannot be embedded on
    backends that cannot transfer complex buffers)."""
    r = rr + 1j * ri
    tmpl = jnp.asarray(tmpl_r) + 1j * jnp.asarray(tmpl_i)
    metric, p, half = _sc_metric(r, n_valid, m)
    coarse = jnp.argmax(metric)
    best, peak, cfo = _refine(
        rr, ri, metric, p, half, coarse[None], tmpl, n_valid, m
    )
    return peak[0], best[0], cfo[0]


def _topk_core(rr, ri, metric, p, half, tmpl, n_valid, m, k: int, cp=None):
    """Top-K candidate detection, fully parallel (no sequential argmax
    loop, so K can be large): windowed local maxima (window 2m, which
    suppresses one frame's metric plateau — distinct frames are
    >= prefix_len >> 2m apart) -> non-max suppression against neighbor
    windows -> lax.top_k -> one vectorized refinement pass.
    Returns (bests (K',), peaks (K',), cfos (K',)) with K' = min(K, #windows)."""
    w = 2 * m
    nwin = -(-metric.shape[0] // w)
    mm = jnp.pad(metric, (0, nwin * w - metric.shape[0]), constant_values=-1.0)
    wm = mm.reshape(nwin, w)
    wmax = jnp.max(wm, axis=1)
    warg = jnp.argmax(wm, axis=1) + jnp.arange(nwin) * w
    left = jnp.concatenate([jnp.full(1, -jnp.inf), wmax[:-1]])
    right = jnp.concatenate([wmax[1:], jnp.full(1, -jnp.inf)])
    cand = (wmax >= left) & (wmax > right)  # ties resolve to the right window
    vals = jnp.where(cand, wmax, -1.0)
    keff = min(k, nwin)
    _topv, topi = jax.lax.top_k(vals, keff)
    coarses = warg[topi]
    return _refine(rr, ri, metric, p, half, coarses, tmpl, n_valid, m, cp=cp)


@functools.lru_cache(maxsize=64)
def _detector_for(m: int, tmpl_key: bytes):
    tmpl = np.frombuffer(tmpl_key, np.complex64)
    return jax.jit(
        functools.partial(
            _detect_core,
            tmpl_r=tmpl.real.copy(),
            tmpl_i=tmpl.imag.copy(),
            m=m,
        )
    )


def _to_np_planes(iq) -> tuple[np.ndarray, np.ndarray]:
    """Any IQ form -> host numpy (re, im) float32, fetching only real
    buffers (complex device->host transfers are a portability hazard)."""
    if isinstance(iq, (tuple, list)):
        re, im = iq
        return (
            np.asarray(re, np.float32),
            np.asarray(im, np.float32),
        )
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        return iq.real.astype(np.float32), iq.imag.astype(np.float32)
    re, im = split_iq(iq)
    return np.asarray(re, np.float32), np.asarray(im, np.float32)


def _bucket_len(n: int, floor: int = 1) -> int:
    """Shape bucket for jit compilation caching: the next multiple of an
    eighth of the enclosing power of two (at most 8 distinct compiled
    shapes per octave; padding is <= 12.5% deep into an octave but up to
    ~25% just past a power of two, e.g. 129 -> 160 — still far below the
    ~2x a full power-of-two round-up wasted on steady streaming sizes)."""
    n = max(n, floor, 1)
    p = 1 << max(int(np.ceil(np.log2(n))), 0)
    q = max(p // 8, 1)
    return -(-n // q) * q


def _detect(gen: OFDMFrameGen, iq):
    """Shape-bucketed detection wrapper: pads to the next power of two so the
    jitted core compiles once per bucket, not once per block length.
    Returns (metric_peak_at_best, best, cfo)."""
    m = gen.cfg.num_subcarriers
    tmpl_np = np.concatenate([gen.S0_time, gen.S0_time]).astype(np.complex64)
    det = _detector_for(m, tmpl_np.tobytes())
    re_np, im_np = _to_np_planes(iq)
    n = re_np.shape[0]
    bucket = 1 << max(int(np.ceil(np.log2(max(n, 4 * m)))), 0)
    rr = np.zeros(bucket, np.float32)
    ri = np.zeros(bucket, np.float32)
    rr[:n] = re_np
    ri[:n] = im_np
    return det(jnp.asarray(rr), jnp.asarray(ri), jnp.int32(n))


def _dft_mm(x: jax.Array, m: int) -> jax.Array:
    """DFT along the last axis (length m) as a real-split matmul: at these
    tiny sizes a (rows, m)@(m, m) pair of f32 matmuls needs no complex
    buffers."""
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    wre = np.cos(ang).astype(np.float32)
    wim = np.sin(ang).astype(np.float32)
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)

    def mm(a, b):
        return jnp.matmul(
            a, b, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )

    yr = mm(xr, wre) - mm(xi, wim)
    yi = mm(xr, wim) + mm(xi, wre)
    return (yr + 1j * yi).astype(jnp.complex64)


def _equalized_data_points(gen: OFDMFrameGen, r: jax.Array, cfo: jax.Array,
                           num_symbols: int):
    """r: (B, 2m + m+cp + num_symbols*(m+cp)) aligned at S0. Returns
    equalized data-subcarrier points (B, num_symbols, nd) and rssi (B,)."""
    from cognitive_radio_network_tpu.phy.framegen import pilot_sequence

    cfg = gen.cfg
    m, cp = cfg.num_subcarriers, cfg.cp_len
    b = r.shape[0]
    n = jnp.arange(r.shape[1], dtype=jnp.float32)
    r = r * jnp.exp(-1j * cfo[:, None] * n)
    rssi = 10.0 * jnp.log10(jnp.mean(jnp.abs(r) ** 2, axis=-1) + 1e-20)

    s1_start = 2 * m + cp
    s1_t = r[:, s1_start : s1_start + m]
    body = r[:, s1_start + m :]
    sym = body.reshape(b, num_symbols, m + cp)[:, :, cp:]

    y1 = _dft_mm(s1_t, m) / np.sqrt(m)
    x1 = jnp.asarray(gen.S1_freq)
    act = jnp.asarray(gen.active_idx)
    h = jnp.ones((b, m), jnp.complex64)
    h = h.at[:, act].set(y1[:, act] * jnp.conj(x1[act]) / (jnp.abs(x1[act]) ** 2))

    y = _dft_mm(sym, m) / np.sqrt(m)
    yeq = y / (h[:, None, :] + 1e-12)

    if len(gen.pilot_idx):
        pidx = jnp.asarray(gen.pilot_idx)
        pilots = jnp.asarray(pilot_sequence(num_symbols, len(gen.pilot_idx)))
        dot = jnp.sum(yeq[:, :, pidx] * jnp.conj(pilots[None]), axis=-1)
        yeq = yeq * jnp.exp(-1j * jnp.angle(dot))[:, :, None]

    didx = jnp.asarray(gen.data_idx)
    return yeq[:, :, didx], rssi


def _demod_graph(gen: OFDMFrameGen, re, im, cfo):
    """Full fixed-config frame demod. re/im: (B, frame_len)."""
    cfg = gen.cfg
    r = (re + 1j * im).astype(jnp.complex64)
    b = r.shape[0]
    data, rssi = _equalized_data_points(gen, r, cfo, gen.num_symbols)
    nd = len(gen.data_idx)
    hdr_pts = data[:, : gen.n_header_syms].reshape(b, -1)
    pay_pts = data[:, gen.n_header_syms :].reshape(b, -1)

    hdr_syms, hdr_evm = modem.demodulate(_HEADER_MOD, hdr_pts)
    pay_syms, pay_evm = modem.demodulate(cfg.mod_scheme, pay_pts)

    hdr_bits = hdr_syms[:, : gen.n_header_bits].astype(jnp.uint8)
    shifts = jnp.arange(gen.bps - 1, -1, -1, dtype=jnp.int32)
    pay_bits = ((pay_syms[:, :, None] >> shifts) & 1).reshape(b, -1).astype(jnp.uint8)[
        :, : gen.payload_enc_bytes * 8
    ]

    n_pay_syms_used = gen.payload_enc_bytes * 8 // gen.bps
    n_used = gen.n_header_bits + n_pay_syms_used
    evm_lin = (
        jnp.sum(hdr_evm[:, : gen.n_header_bits], axis=-1)
        + jnp.sum(pay_evm[:, :n_pay_syms_used], axis=-1)
    ) / n_used
    evm_db = 10.0 * jnp.log10(evm_lin + 1e-20)
    return {
        "header_bits": hdr_bits,
        "payload_bits": pay_bits,
        "evm_db": evm_db,
        "rssi_db": rssi,
    }


def _header_demod_graph(gen: OFDMFrameGen, re, im, cfo):
    """Header-only demod over the fixed-size frame prefix."""
    r = (re + 1j * im).astype(jnp.complex64)
    b = r.shape[0]
    data, rssi = _equalized_data_points(gen, r, cfo, gen.n_header_syms)
    hdr_pts = data.reshape(b, -1)
    hdr_syms, _ = modem.demodulate(_HEADER_MOD, hdr_pts)
    return hdr_syms[:, : gen.n_header_bits].astype(jnp.uint8), rssi


def _decode_header_graph(hdr_bits):
    """Coded header bits (B, n) -> (user (B,8), phy (B,6), crc_ok (B,))."""
    n_hdr_dec = TOTAL_HEADER_BYTES + crc_mod.crc_sizes(_HEADER_CRC)
    hdr_dec = fec_mod.decode_bits_jnp(_HEADER_FEC, hdr_bits, n_hdr_dec)
    hdr_ok = crc_mod.crc_check_jnp(_HEADER_CRC, hdr_dec)
    return (
        hdr_dec[:, :HEADER_BYTES],
        hdr_dec[:, HEADER_BYTES:TOTAL_HEADER_BYTES],
        hdr_ok,
    )


def _rx_graph(gen: OFDMFrameGen, re, im, cfo):
    """Fused frame receive: demod + header/payload FEC + CRC, all in-graph.

    re/im: (B, frame_len).  Replaces the reference's per-frame host decode
    (liquid fec_decode + crc inside rxCallback,
    src/extensible_cognitive_radio.cpp:1385-1454) with one batched graph."""
    from cognitive_radio_network_tpu.phy.bits import unpack_bits_jnp

    out = _demod_graph(gen, re, im, cfo)
    cfg = gen.cfg
    headers, phy, hdr_ok = _decode_header_graph(out["header_bits"])
    n_dec = gen.payload_len + crc_mod.crc_sizes(cfg.crc_scheme)
    n0 = fec_mod.encoded_length(cfg.fec0, n_dec)
    inner = fec_mod.decode_bits_jnp(cfg.fec1, out["payload_bits"], n0)
    pay_dec = fec_mod.decode_bits_jnp(cfg.fec0, unpack_bits_jnp(inner), n_dec)
    pay_ok = crc_mod.crc_check_jnp(cfg.crc_scheme, pay_dec)
    return {
        "headers": headers,
        "phy": phy,
        "payloads": pay_dec[:, : gen.payload_len],
        "hdr_ok": hdr_ok,
        "pay_ok": pay_ok,
        "evm_db": out["evm_db"],
        "rssi_db": out["rssi_db"],
        "cfo": jnp.asarray(cfo, jnp.float32),
    }


def _rx_at_graph(gen: OFDMFrameGen, rr, ri, offsets, cfos):
    """Gather frames at dynamic offsets from a block, then fused receive.

    rr/ri: (N,) planes; offsets (G,) int32; cfos (G,) float32.  Frame
    windows are contiguous DMA rows, not a fancy-index gather."""
    from cognitive_radio_network_tpu.ops.extract import extract_windows

    fre, fim = extract_windows(rr, ri, offsets, gen.frame_len)
    return _rx_graph(gen, fre, fim, cfos)


def _receive_block_graph(gen: OFDMFrameGen, rr, ri, n_valid, *, k: int):
    """ONE-dispatch fixed-config block receive: top-K detect + gather +
    demod + FEC + CRC, fused.  Returns (bests, peaks, cfos, rx dict, ok)
    where ok = header CRC & payload fits inside the valid samples.

    This is the batched replacement for liquid's per-sample streaming
    synchronizer at full rate (ofdmflexframesync_execute inside
    ECR_rx_worker, src/extensible_cognitive_radio.cpp:1299-1366): dispatches
    pipeline on the device, so throughput is compute-bound, not
    host-round-trip-bound."""
    m = gen.cfg.num_subcarriers
    tmpl_np = np.concatenate([gen.S0_time, gen.S0_time]).astype(np.complex64)
    r = rr + 1j * ri
    tmpl = jnp.asarray(tmpl_np.real) + 1j * jnp.asarray(tmpl_np.imag)
    metric, p, half = _sc_metric(r, n_valid, m)
    bests, peaks, cfos = _topk_core(
        rr, ri, metric, p, half, tmpl, n_valid, m, k, cp=gen.cfg.cp_len
    )
    out = _rx_at_graph(gen, rr, ri, bests, cfos)
    ok = out["hdr_ok"] & (bests + gen.frame_len <= n_valid)
    return bests, peaks, cfos, out, ok


def _scan_block_graph(layout: OFDMFrameGen, rr, ri, n_valid, *, k: int):
    """One-dispatch block scan: top-K S&C candidates + header demod +
    header FEC/CRC decode for all K at once.

    Returns (bests, peaks, cfos, headers (K,8), phy (K,6), hdr_ok (K,))
    with hdr_ok False for candidates whose header region overruns the
    valid samples."""
    from cognitive_radio_network_tpu.ops.extract import extract_windows

    m = layout.cfg.num_subcarriers
    tmpl_np = np.concatenate([layout.S0_time, layout.S0_time]).astype(np.complex64)
    r = rr + 1j * ri
    tmpl = jnp.asarray(tmpl_np.real) + 1j * jnp.asarray(tmpl_np.imag)
    metric, p, half = _sc_metric(r, n_valid, m)
    bests, peaks, cfos = _topk_core(
        rr, ri, metric, p, half, tmpl, n_valid, m, k, cp=layout.cfg.cp_len
    )
    pref = (
        2 * m
        + (m + layout.cfg.cp_len)
        + layout.n_header_syms * (m + layout.cfg.cp_len)
    )
    pre_r, pre_i = extract_windows(rr, ri, bests, pref)
    hdr_bits, _rssi = _header_demod_graph(layout, pre_r, pre_i, cfos)
    headers, phy, hdr_ok = _decode_header_graph(hdr_bits)
    hdr_ok = hdr_ok & (bests + pref <= n_valid)
    return bests, peaks, cfos, headers, phy, hdr_ok


# ----------------------------------------------------------------------
# process-wide compiled-graph caches
#
# All rx graphs are pure functions of (frame config, payload_len[, k]), so
# one compilation serves every radio instance with that configuration —
# jax.jit caches on function identity, and a fresh functools.partial per
# instance would defeat it (48 identically-configured nodes would compile
# the same graph 48 times; see gen_for in phy/framegen.py).
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def _rx_jit_for(cfg: OFDMFrameConfig, payload_len: int):
    return jax.jit(functools.partial(_rx_graph, gen_for(cfg, payload_len)))


@functools.lru_cache(maxsize=512)
def _rx_at_jit_for(cfg: OFDMFrameConfig, payload_len: int):
    return jax.jit(functools.partial(_rx_at_graph, gen_for(cfg, payload_len)))


@functools.lru_cache(maxsize=512)
def _rx_block_jit_for(cfg: OFDMFrameConfig, payload_len: int, k: int):
    return jax.jit(
        functools.partial(_receive_block_graph, gen_for(cfg, payload_len), k=k)
    )


@functools.lru_cache(maxsize=512)
def _scan_jit_for(cfg: OFDMFrameConfig, k: int):
    return jax.jit(functools.partial(_scan_block_graph, gen_for(cfg, 1), k=k))


# Packed variants: ONE device->host transfer per dispatch instead of one
# per output array, so the streaming receiver's per-block cost is 1 + 2
# transfers instead of 6 for the scan + 8 for each decode.


def _scan_block_graph_packed(layout, rr, ri, n_valid, *, k: int):
    bests, peaks, cfos, headers, phy, hdr_ok = _scan_block_graph(
        layout, rr, ri, n_valid, k=k
    )
    cols = [
        bests.astype(jnp.int32)[:, None],
        jax.lax.bitcast_convert_type(peaks.astype(jnp.float32), jnp.int32)[:, None],
        jax.lax.bitcast_convert_type(cfos.astype(jnp.float32), jnp.int32)[:, None],
        hdr_ok.astype(jnp.int32)[:, None],
        headers.astype(jnp.int32),
        phy.astype(jnp.int32),
    ]
    return jnp.concatenate(cols, axis=1)  # (K, 18) int32


def _unpack_scan(packed: np.ndarray):
    bests = packed[:, 0]
    peaks = np.ascontiguousarray(packed[:, 1]).view(np.float32)
    cfos = np.ascontiguousarray(packed[:, 2]).view(np.float32)
    hdr_ok = packed[:, 3].astype(bool)
    headers = packed[:, 4:12].astype(np.uint8)
    phy = packed[:, 12:18].astype(np.uint8)
    return bests, peaks, cfos, headers, phy, hdr_ok


def _rx_at_graph_packed(gen, rr, ri, offsets, cfos):
    """Decode outputs packed into TWO transfers: a uint8 array (headers,
    phy, payloads, ok flags) and an f32 (G, 3) (evm, rssi, cfo) — byte-
    level bitcasting the floats into the uint8 array would need byte
    shuffles in the graph."""
    out = _rx_at_graph(gen, rr, ri, offsets, cfos)
    bytes_cols = [
        out["headers"],
        out["phy"],
        out["payloads"],
        out["hdr_ok"].astype(jnp.uint8)[:, None],
        out["pay_ok"].astype(jnp.uint8)[:, None],
    ]
    f32_cols = jnp.stack(
        [out["evm_db"], out["rssi_db"], out["cfo"]], axis=1
    )  # (G, 3)
    return jnp.concatenate(bytes_cols, axis=1), f32_cols


def _unpack_rx(bytes_packed: np.ndarray, f32_packed: np.ndarray, payload_len: int):
    b = np.asarray(bytes_packed)
    f = np.asarray(f32_packed)
    p = payload_len
    return {
        "headers": b[:, :8],
        "phy": b[:, 8:14],
        "payloads": b[:, 14 : 14 + p],
        "hdr_ok": b[:, 14 + p].astype(bool),
        "pay_ok": b[:, 15 + p].astype(bool),
        "evm_db": f[:, 0],
        "rssi_db": f[:, 1],
        "cfo": f[:, 2],
    }


@functools.lru_cache(maxsize=512)
def _scan_packed_jit_for(cfg: OFDMFrameConfig, k: int):
    return jax.jit(
        functools.partial(_scan_block_graph_packed, gen_for(cfg, 1), k=k)
    )


@functools.lru_cache(maxsize=512)
def _scan_packed_buf_jit_for(cfg: OFDMFrameConfig, k: int, bucket: int):
    """Single-upload variant for the host streaming path: ONE f32 array
    [n_valid | rr | ri] instead of three transfers — per-call host->device
    fixed costs (one per array, scalars included) dominated the radio
    runtime's per-block scan on the CPU backend."""
    layout = gen_for(cfg, 1)

    def fn(buf):
        n_valid = buf[0].astype(jnp.int32)
        rr = jax.lax.slice_in_dim(buf, 1, 1 + bucket)
        ri = jax.lax.slice_in_dim(buf, 1 + bucket, 1 + 2 * bucket)
        return _scan_block_graph_packed(layout, rr, ri, n_valid, k=k)

    return jax.jit(fn)


@functools.lru_cache(maxsize=512)
def _rx_at_packed_jit_for(cfg: OFDMFrameConfig, payload_len: int):
    return jax.jit(
        functools.partial(_rx_at_graph_packed, gen_for(cfg, payload_len))
    )


@functools.lru_cache(maxsize=512)
def _rx_at_packed_buf_jit_for(cfg: OFDMFrameConfig, payload_len: int, bucket: int):
    """Single-upload decode for the host streaming path: the stream rides
    the scan's packed [n | rr | ri] buffer (already on device) and the
    offsets/cfos arrive as ONE f32 array [offs.bits | cfs]."""
    gen = gen_for(cfg, payload_len)

    def fn(buf, oc):
        rr = jax.lax.slice_in_dim(buf, 1, 1 + bucket)
        ri = jax.lax.slice_in_dim(buf, 1 + bucket, 1 + 2 * bucket)
        g = oc.shape[0] // 2
        offs = jax.lax.bitcast_convert_type(oc[:g], jnp.int32)
        return _rx_at_graph_packed(gen, rr, ri, offs, oc[g:])

    return jax.jit(fn)


# ----------------------------------------------------------------------
# fused adaptive stream step (scan + in-graph candidate resolution +
# speculative decode + residual carry, ONE dispatch per block)
# ----------------------------------------------------------------------


def _phy_geometry(layout: OFDMFrameGen, phy: jax.Array):
    """In-graph frame geometry from decoded PHY headers.

    phy: (K, 6) uint8 [payload_len lo | hi | mod | fec0 | fec1 | crc].
    Returns (frame_len (K,) int32, valid (K,) bool) — the vectorized
    equivalent of ``unpack_phy_header`` + ``OFDMFrameGen`` sizing
    (phy/framegen.py:173-194), so candidate resolution (overlap
    suppression with the TRUE per-frame length, incomplete-frame carry)
    can run inside the stream-step graph regardless of which payload
    configs the frames carry."""
    p = phy[:, 0].astype(jnp.int32) | (phy[:, 1].astype(jnp.int32) << 8)
    mod_i = phy[:, 2].astype(jnp.int32)
    f0_i = phy[:, 3].astype(jnp.int32)
    f1_i = phy[:, 4].astype(jnp.int32)
    crc_i = phy[:, 5].astype(jnp.int32)
    valid = (
        (mod_i < len(modem.SCHEMES))
        & (f0_i < len(fec_mod.SCHEMES))
        & (crc_i < len(crc_mod.SCHEMES))
        & (f1_i < len(fec_mod.SCHEMES))
    )
    crc_tab = jnp.asarray(
        [crc_mod.crc_sizes(s) for s in crc_mod.SCHEMES], jnp.int32
    )
    n_dec = p + crc_tab[jnp.clip(crc_i, 0, len(crc_mod.SCHEMES) - 1)]

    def fec_len(idx, nb):
        # per-scheme encoded_length formulas (phy/fec.py:354-366), selected
        # element-wise: none, rep3, h74, h128, v27
        opts = jnp.stack(
            [
                nb,
                3 * nb,
                (nb * 14 + 7) // 8,
                (nb * 12 + 7) // 8,
                (2 * (8 * nb + fec_mod._CONV_K - 1) + 7) // 8,
            ],
            axis=-1,
        )  # (K, 5)
        return jnp.take_along_axis(
            opts, jnp.clip(idx, 0, 4)[:, None], axis=-1
        )[:, 0]

    enc0 = fec_len(f0_i, n_dec)
    enc_bytes = fec_len(f1_i, enc0)
    bps_tab = jnp.asarray(
        [modem.bits_per_symbol(s) for s in modem.SCHEMES], jnp.int32
    )
    bps = bps_tab[jnp.clip(mod_i, 0, len(modem.SCHEMES) - 1)]
    total_mod_syms = (enc_bytes * 8 + bps - 1) // bps
    nd = len(layout.data_idx)
    n_payload_syms = (total_mod_syms + nd - 1) // nd
    m, cp = layout.cfg.num_subcarriers, layout.cfg.cp_len
    num_symbols = layout.n_header_syms + n_payload_syms
    frame_len = 2 * m + (m + cp) * (1 + num_symbols)
    return frame_len, valid


def _stream_step_graph(
    layout: OFDMFrameGen,
    spec_gens: tuple[OFDMFrameGen, ...],
    max_residual: int,
    res_r,
    res_i,
    res_len,
    blk_r,
    blk_i,
    thr,
    *,
    k: int,
):
    """ONE-dispatch adaptive stream step: scan + greedy candidate
    resolution + speculative decode + residual carry, all in-graph.

    Replaces :meth:`StreamReceiver.process_device`'s per-block host loop
    (scan fetch -> host ordering/config grouping -> per-config decode
    dispatch -> fetch), which paid a host round trip per stage.  The host
    semantics are
    reproduced exactly:

    * candidates ordered by position (stable), greedy-accepted against
      threshold, header CRC, header parse validity, and overlap with the
      previously accepted frame using each candidate's TRUE frame length
      from its own PHY header (:func:`_phy_geometry`);
    * the incomplete-frame break (header/frame region overruns the buffer)
      stops acceptance and pulls the residual keep-point back to the frame
      start, so the tail decodes next block;
    * the residual (right-aligned in an r_cap buffer) is re-sliced on
      device — state never crosses the host boundary, so successive steps
      pipeline with NO host round trip between dispatches.

    Payload decode runs speculatively against ``spec_gens`` (the 1-2 most
    recently seen payload configs): every candidate is decoded under each
    spec config in the same dispatch, and a per-candidate ``match_idx``
    records which spec (if any) equals its PHY header.  Mismatched frames
    (config just changed) fall back to the host-grouped decode path on the
    exported buffer planes — rare, and only those frames pay the extra
    round trip.

    Returns (new_res_r, new_res_i, new_res_len, buf_r, buf_i, packed)
    where ``packed`` is ONE int32 array (k+1, 10 + 2*S + ceil(W/4)): cols
    0..9+2S, rows 0..k-1 = [best, cfo.bits, accept, match_idx, phy[6],
    then per spec (evm, rssi).bits]; row k = meta [res_len_in, keep_from,
    consumed_end, incomplete, tiny, 0...]; the remaining columns are each
    candidate's MATCHED-spec decode bytes (uint8 (k, Wmax), Wmax =
    max_s(16 + P_s), headers/phy/ok flags included) packed little-endian
    4-bytes-per-word.  One host-fetchable output per step, because each
    fetched array costs a host round trip.
    """
    r_cap = res_r.shape[0]
    buf_r = jnp.concatenate([res_r, blk_r])
    buf_i = jnp.concatenate([res_i, blk_i])
    n = buf_r.shape[0]  # static: r_cap + block_len
    lead = r_cap - res_len
    n_live = res_len + blk_r.shape[0]
    prefix = (
        2 * layout.cfg.num_subcarriers
        + (layout.cfg.num_subcarriers + layout.cfg.cp_len)
        * (1 + layout.n_header_syms)
    )

    bests, peaks, cfos, headers, phy, hdr_ok = _scan_block_graph(
        layout, buf_r, buf_i, jnp.int32(n), k=k
    )
    flen, phy_valid = _phy_geometry(layout, phy)

    # greedy resolution in offset order (the host loop of
    # _resolve_candidates, as a lax.scan with a scalar carry)
    order = jnp.argsort(bests)  # stable
    ob = bests[order].astype(jnp.int32)
    opk = peaks[order]
    ohok = hdr_ok[order]
    oval = phy_valid[order]
    ofl = flen[order]
    keep0 = jnp.maximum(jnp.int32(n - prefix), lead.astype(jnp.int32))

    def body(carry, x):
        consumed, stopped, keep_from, incomplete = carry
        off, pk, hok, val, fl = x
        considered = (~stopped) & (pk >= thr) & (off >= consumed)
        prefix_overrun = considered & (off + prefix > n)
        after_hdr = considered & (~prefix_overrun) & hok & val
        frame_overrun = after_hdr & (off + fl > n)
        accept = after_hdr & (~frame_overrun)
        consumed = jnp.where(accept, off + fl, consumed)
        stop_now = prefix_overrun | frame_overrun
        keep_from = jnp.where(
            stop_now, jnp.minimum(keep_from, off), keep_from
        )
        return (
            consumed,
            stopped | stop_now,
            keep_from,
            incomplete | stop_now,
        ), accept

    (consumed_end, _, keep_from, incomplete), acc_sorted = jax.lax.scan(
        body,
        (jnp.int32(0), jnp.bool_(False), keep0, jnp.bool_(False)),
        (ob, opk, ohok, oval, ofl),
        # the body is ~15 scalar ops, so per-iteration loop overhead
        # dominates — unrolled, the K-candidate resolution costs ~K/32
        # iterations instead of K
        unroll=min(32, ob.shape[0]),
    )
    accept = jnp.zeros(ob.shape[0], jnp.bool_).at[order].set(acc_sorted)

    # the tiny-block early-out of the host path: too short to scan ->
    # accept nothing, keep the whole live region, leave pending unchanged
    m4 = 4 * layout.cfg.num_subcarriers
    tiny = n_live < prefix + m4
    accept = accept & ~tiny

    # residual carry (right-aligned, zeros before the keep point)
    keep2 = jnp.maximum(keep_from, consumed_end)
    keep2 = jnp.maximum(keep2, jnp.int32(n - max_residual))
    keep2 = jnp.where(tiny, lead.astype(jnp.int32), keep2)
    new_res_len = jnp.int32(n) - keep2
    tail_r, tail_i = buf_r[-r_cap:], buf_i[-r_cap:]
    live = jnp.arange(r_cap) >= r_cap - new_res_len
    new_res_r = jnp.where(live, tail_r, 0.0)
    new_res_i = jnp.where(live, tail_i, 0.0)

    # speculative decode under each spec config (shared window gather per
    # spec; frames whose header matches no spec fall back on the host)
    match_idx = jnp.full(ob.shape[0], -1, jnp.int32)
    dec_bytes, dec_f32 = [], []
    for s, sg in enumerate(spec_gens):
        spec_phy = pack_phy_header(sg.cfg, sg.payload_len)
        m_s = jnp.all(phy == jnp.asarray(spec_phy), axis=1)
        match_idx = jnp.where((match_idx < 0) & m_s, s, match_idx)
        db, df = _rx_at_graph_packed(sg, buf_r, buf_i, bests, cfos)
        dec_bytes.append(db)
        dec_f32.append(df)

    # minimal record: the decoded user header rides the DECODE bytes, the
    # per-spec cfo column is the scan cfo — only [best, cfo, accept,
    # match, phy[6]] plus per-spec (evm, rssi) is fetched.  The PHY header
    # comes from the SCAN (not the dec bytes): a mismatched candidate's
    # speculative decode window (the spec's frame length, possibly longer
    # than the real frame) can clip at the buffer end and garble its dec
    # row, and the fallback path needs the exact phy to resolve configs.
    # The fetch link runs at ~60 MB/s with ~25 ms latency; every byte is
    # throughput.
    cols = [
        bests.astype(jnp.int32)[:, None],
        jax.lax.bitcast_convert_type(cfos.astype(jnp.float32), jnp.int32)[
            :, None
        ],
        accept.astype(jnp.int32)[:, None],
        match_idx[:, None],
        phy.astype(jnp.int32),
        *(
            jax.lax.bitcast_convert_type(
                df[:, :2].astype(jnp.float32), jnp.int32
            )
            for df in dec_f32
        ),
    ]
    rec = jnp.concatenate(cols, axis=1)  # (k, 10 + 2*S)
    meta = jnp.stack(
        [
            res_len.astype(jnp.int32),
            keep2,
            consumed_end,
            incomplete.astype(jnp.int32),
            tiny.astype(jnp.int32),
        ]
    )
    meta = jnp.pad(meta, (0, rec.shape[1] - meta.shape[0]))
    rec = jnp.concatenate([rec, meta[None, :]], axis=0)  # (k+1, 10+2S)
    # per candidate, keep ONLY the decode bytes of its MATCHED spec (the
    # other spec's decode is garbage for it anyway); unmatched candidates
    # default to spec 0's bytes, whose header columns are still exact
    wmax = max(db.shape[1] for db in dec_bytes)
    dec = jnp.pad(
        dec_bytes[0], ((0, 0), (0, wmax - dec_bytes[0].shape[1]))
    )
    for s, db in enumerate(dec_bytes[1:], start=1):
        dbp = jnp.pad(db, ((0, 0), (0, wmax - db.shape[1])))
        dec = jnp.where(match_idx[:, None] == s, dbp, dec)
    # pack the decode bytes into int32 words (little-endian) and append to
    # the record: ONE fetchable output per step — every extra array is an
    # extra ~25-36 ms round trip in the prefetch pipeline
    w = dec.shape[1]
    wp = -(-w // 4) * 4
    dec = jnp.pad(dec, ((0, 0), (0, wp - w))).reshape(dec.shape[0], wp // 4, 4)
    d32 = jnp.sum(
        dec.astype(jnp.int32)
        << jnp.asarray([0, 8, 16, 24], jnp.int32)[None, None, :],
        axis=-1,
    )
    d32 = jnp.pad(d32, ((0, 1), (0, 0)))  # meta row alignment
    packed = jnp.concatenate([rec, d32], axis=1)  # (k+1, 20+3S + wp/4)
    return new_res_r, new_res_i, new_res_len, buf_r, buf_i, packed


@functools.lru_cache(maxsize=256)
def _stream_step_jit_for(
    cfg: OFDMFrameConfig,
    spec_keys: tuple,
    k: int,
    max_residual: int,
):
    layout = gen_for(cfg, 1)
    spec_gens = tuple(
        gen_for(
            dataclasses.replace(
                cfg, mod_scheme=mod, fec0=f0, fec1=f1, crc_scheme=chk
            ),
            plen,
        )
        for (plen, mod, f0, f1, chk) in spec_keys
    )
    return jax.jit(
        functools.partial(
            _stream_step_graph, layout, spec_gens, max_residual, k=k
        )
    )


# ----------------------------------------------------------------------
# adaptive streaming receiver
# ----------------------------------------------------------------------


class StreamReceiver:
    """liquid-style adaptive receiver: only the OFDM geometry (subcarriers,
    CP, taper, allocation) is fixed; payload length/mod/FEC/CRC come from
    each frame's PHY header.  Feed arbitrary IQ blocks; frames straddling
    block boundaries are handled by a residual buffer.

    Dispatch discipline: O(1) device dispatches per block — one fused scan
    (top-K detection + batched header demod/decode) + one fused batched
    demod+decode per distinct payload configuration in the block."""

    def __init__(self, cfg: OFDMFrameConfig, max_frames_per_block: int = 16):
        self.cfg = cfg
        self.layout = gen_for(cfg, 1)
        m, cp = cfg.num_subcarriers, cfg.cp_len
        self.prefix_len = 2 * m + (m + cp) + self.layout.n_header_syms * (m + cp)
        self._syncs: dict[tuple, OFDMFrameSync] = {}
        self.max_frames_per_block = max_frames_per_block
        self._residual = np.zeros(0, np.complex64)
        self._residual_offset = 0  # absolute sample index of residual[0]
        # device-resident state (the fused process_device/feed_device path):
        # residual planes + length live ON DEVICE and chain between step
        # dispatches with no host round trip in between
        self._res_r_d = None
        self._res_i_d = None
        self._res_len_d = None
        self._res_cap = 0
        # speculative-decode config history: the <= 2 most recently seen
        # payload configs (keys as in _sync_for); the initial guess is the
        # constructor config at the reference's 256-byte packet size
        # (include/crts.hpp:192-194)
        self._spec_lru: list[tuple] = [
            (256, cfg.mod_scheme, cfg.fec0, cfg.fec1, cfg.crc_scheme)
        ]
        self._pending_steps: list[tuple] = []  # in-flight fused steps
        # fetch batching: device->host round trips cost ~25-36 ms EACH and
        # serialize on this backend, so consecutive steps' packed records
        # are stacked device-side and fetched in ONE transfer per group
        self.fetch_group = 8
        self._open_group: dict | None = None
        # True while the residual holds a detected-but-incomplete frame
        # (its tail is still arriving) — the squelch must not carry/skip
        # past such a block (runtime/radio.py in-band gate)
        self.pending_frame = False

    def _sync_for(self, payload_len, mod, f0, f1, check) -> OFDMFrameSync:
        key = (payload_len, mod, f0, f1, check)
        if key not in self._syncs:
            cfg = dataclasses.replace(
                self.cfg, mod_scheme=mod, fec0=f0, fec1=f1, crc_scheme=check
            )
            self._syncs[key] = OFDMFrameSync(cfg, payload_len)
        return self._syncs[key]

    def skip(self, n: int) -> None:
        """Advance the stream cursor past ``n`` squelched samples without
        scanning them (the radio's noise-floor squelch, runtime/radio.py):
        the residual is discarded — by construction it carries no frame —
        and absolute offsets stay consistent across the gap."""
        self._residual_offset += len(self._residual) + int(n)
        self._residual = np.zeros(0, np.complex64)
        self.pending_frame = False

    def carry(self, iq) -> None:
        """Advance past a squelched block WITHOUT scanning it, keeping an
        eighth-block + prefix tail in the residual (the radio's in-band
        squelch): a frame whose head starts near the end of a cold block —
        by the squelch power bound, a head small enough to read cold is
        contained in that tail — still decodes whole when the next hot
        block arrives."""
        re_np, im_np = _to_np_planes(iq)
        block = (re_np + 1j * im_np).astype(np.complex64)
        buf = np.concatenate([self._residual, block])
        keep = min(self.prefix_len + len(block) // 8, len(buf))
        self._residual_offset += len(buf) - keep
        self._residual = buf[len(buf) - keep :]

    def process(self, iq, threshold: float = 0.2):
        """Append a block and extract every decodable frame.

        Returns a list of dicts: {offset, stats, header, payload} with
        ``offset`` the absolute sample index of the frame start.
        """
        re_np, im_np = _to_np_planes(iq)
        block = re_np + 1j * im_np
        buf = np.concatenate([self._residual, block.astype(np.complex64)])
        base = self._residual_offset
        n = len(buf)
        # position to keep from for the next block: by default just a
        # preamble-sized tail; an incomplete frame pulls it back to its start
        keep_from = max(n - self.prefix_len, 0)
        if n < self.prefix_len + 4 * self.cfg.num_subcarriers:
            self._residual = buf
            return []

        # dispatch 1: scan the whole buffer for up to K frame candidates.
        # K is bounded by physics: decodable frames are at least a header
        # prefix apart, so small blocks need far fewer candidates than the
        # configured max (the refinement pass is O(K) — the scan's main
        # cost at radio block sizes).
        bucket = _bucket_len(n, 4 * self.cfg.num_subcarriers)
        # keff derives from the BUCKET, not n: a fresh (shape, k) pair per
        # block length would retrace/lower the scan graph (~2 s each) for
        # every residual-length variation
        keff = min(
            self.max_frames_per_block, max(4, -(-bucket // self.prefix_len))
        )
        # ONE packed upload [n | rr | ri]: per-array host->device fixed
        # costs (scalars included) dominated the per-block scan overhead
        host = np.zeros(1 + 2 * bucket, np.float32)
        host[0] = n
        host[1 : 1 + n] = buf.real
        host[1 + bucket : 1 + bucket + n] = buf.imag
        buf_d = jnp.asarray(host)
        bests, peaks, cfos, headers, phys, hdr_ok = _unpack_scan(
            np.asarray(_scan_packed_buf_jit_for(self.cfg, keff, bucket)(buf_d))
        )

        accepted, consumed_end, keep_from = self._resolve_candidates(
            bests, peaks, hdr_ok, phys, n, threshold, keep_from
        )
        frames = self._decode_groups(
            buf_d, None, accepted, cfos, base, bucket=bucket
        )

        keep_from = max(keep_from, consumed_end)
        # never let the residual grow beyond a bound (malformed stream guard)
        keep_from = max(keep_from, n - self.max_residual)
        self._residual = buf[keep_from:]
        self._residual_offset = base + keep_from
        return frames

    @property
    def max_residual(self) -> int:
        return 4 * (self.prefix_len + 64 * self.cfg.symbol_len)

    def _resolve_candidates(
        self, bests, peaks, hdr_ok, phys, n, threshold, keep_from
    ):
        """Host side of the adaptive receive: order candidates by position,
        resolve per-frame configs from the decoded PHY headers, group by
        config, and track the incomplete-frame carry point."""
        accepted: dict[tuple, list[tuple[int, int]]] = {}  # key -> [(off, cand)]
        consumed_end = 0
        incomplete = False
        for i in np.argsort(bests, kind="stable"):
            off, pk = int(bests[i]), float(peaks[i])
            if pk < threshold or off < consumed_end:
                continue
            if off + self.prefix_len > n:
                # header region incomplete; wait for more samples
                keep_from = min(keep_from, off)
                incomplete = True
                break
            if not hdr_ok[i]:
                continue  # false peak (or corrupted header): skip
            parsed = unpack_phy_header(phys[i])
            if parsed is None:
                continue
            sync = self._sync_for(*parsed)
            flen = sync.gen.frame_len
            if off + flen > n:
                keep_from = min(keep_from, off)
                incomplete = True
                break  # frame incomplete; resume next block
            accepted.setdefault(parsed, []).append((off, int(i)))
            consumed_end = off + flen
        self.pending_frame = incomplete
        return accepted, consumed_end, keep_from

    def _decode_groups(self, rr_d, ri_d, accepted, cfos, base, bucket=None):
        """Dispatch 2..: one fused batched demod+decode per payload config,
        padded to the next power of two so each sync compiles once per
        size bucket (the previous flat max_frames_per_block padding made
        the radio runtime's common case — ONE frame in a block — pay a
        16-frame decode every time).  All configs are DISPATCHED first and
        their outputs fetched concurrently (each fetch is a host round
        trip; overlapped, G configs cost ~one)."""
        pending = []
        for parsed, items in accepted.items():
            sync = self._sync_for(*parsed)
            g = len(items)
            kpad = min(
                1 << max(g - 1, 0).bit_length(), self.max_frames_per_block
            )
            kpad = max(kpad, g)  # max_frames_per_block may not be a pow2
            if bucket is not None:
                # packed-buffer path: rr_d IS the scan's [n|rr|ri] upload;
                # offsets+cfos travel as one array (one upload, not two)
                oc = np.zeros(2 * kpad, np.float32)
                oc[:g] = (
                    np.asarray([off for off, _ in items], np.int32)
                    .view(np.float32)
                )
                oc[kpad : kpad + g] = [float(cfos[i]) for _, i in items]
                bpk, fpk = _rx_at_packed_buf_jit_for(
                    sync.cfg, sync.payload_len, bucket
                )(rr_d, jnp.asarray(oc))
            else:
                offs = np.zeros(kpad, np.int32)
                cf = np.zeros(kpad, np.float32)
                offs[:g] = [off for off, _ in items]
                cf[:g] = [float(cfos[i]) for _, i in items]
                bpk, fpk = _rx_at_packed_jit_for(sync.cfg, sync.payload_len)(
                    rr_d, ri_d, jnp.asarray(offs), jnp.asarray(cf)
                )
            pending.append((sync, items, bpk, fpk))
        if len(pending) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(2 * len(pending)) as pool:
                fetched = list(
                    pool.map(np.asarray, [x for p_ in pending for x in p_[2:]])
                )
        else:
            fetched = [np.asarray(x) for p_ in pending for x in p_[2:]]
        frames = []
        for gi, (sync, items, _b, _f) in enumerate(pending):
            out = _unpack_rx(
                fetched[2 * gi], fetched[2 * gi + 1], sync.payload_len
            )
            for j, (off, _i) in enumerate(items):
                frames.append(
                    {
                        "offset": base + off,
                        "stats": sync._stats_from(out, j),
                        "header": out["headers"][j],
                        "payload": out["payloads"][j],
                    }
                )
        frames.sort(key=lambda f: f["offset"])
        return frames

    def process_device(self, blk_r, blk_i, threshold: float = 0.2):
        """Device-resident streaming receive: like :meth:`process`, but the
        block planes are ALREADY on device (e.g. produced by an upstream
        jitted stage or DMA'd by the native IQ loader) and ALL stream state
        (residual planes + length) lives on device — the whole step (scan +
        candidate resolution + decode + residual carry) is ONE fused
        dispatch (:func:`_stream_step_graph`); per block only the packed
        step record crosses the host boundary, never the samples.

        The host-side semantics (candidate ordering, config resolution,
        residual carry, pending_frame) are identical to :meth:`process`;
        interleaving the two APIs on one receiver is not supported.
        Synchronous: the step's results are fetched before returning.  For
        throughput, use :meth:`feed_device` + :meth:`flush`, which keep
        several steps in flight (state chains device-side, so dispatches
        pipeline with no host round trip in between)."""
        frames = self.feed_device(blk_r, blk_i, threshold, max_lag=0)
        return frames

    def feed_device(
        self, blk_r, blk_i, threshold: float = 0.2, max_lag: int = 3
    ):
        """Pipelined device-resident streaming: dispatch the fused stream
        step for this block and return the frames of any step whose results
        are due (more than ``max_lag`` steps behind).  Call :meth:`flush`
        to drain the tail; ``pending_frame`` is only current after a flush
        (or with ``max_lag=0``)."""
        r_cap = _bucket_len(self.max_residual)
        if self._res_r_d is None or self._res_cap != r_cap:
            self._res_cap = r_cap
            self._res_r_d = jnp.zeros(r_cap, jnp.float32)
            self._res_i_d = jnp.zeros(r_cap, jnp.float32)
            self._res_len_d = jnp.int32(0)
        n = r_cap + int(blk_r.shape[0])
        keff = min(self.max_frames_per_block, max(4, -(-n // self.prefix_len)))
        spec = tuple(sorted(self._spec_lru[-2:]))
        fn = _stream_step_jit_for(self.cfg, spec, keff, self.max_residual)
        (
            self._res_r_d,
            self._res_i_d,
            self._res_len_d,
            buf_r,
            buf_i,
            packed,
        ) = fn(
            self._res_r_d,
            self._res_i_d,
            self._res_len_d,
            blk_r,
            blk_i,
            jnp.float32(threshold),
        )
        # group the step's packed record for a batched prefetch: the
        # ~25-36 ms device->host round trip then overlaps the dispatch +
        # device time of the NEXT blocks AND amortizes over fetch_group
        # steps (round trips serialize on this backend, so per-step
        # fetches bounded streaming at ~1 RTT per block)
        g = self._open_group
        if g is not None and g["arrs"] and g["arrs"][0].shape != packed.shape:
            self._submit_group()  # shape changed (new k/spec): close group
            g = None
        if g is None:
            g = self._open_group = {"arrs": [], "fut": None}
        idx = len(g["arrs"])
        g["arrs"].append(packed)
        self._pending_steps.append((g, idx, spec, buf_r, buf_i, r_cap))
        if len(g["arrs"]) >= self.fetch_group:
            self._submit_group()
        if len(self._pending_steps) > max_lag:
            return self._drain(len(self._pending_steps) - max_lag)
        return []

    def _submit_group(self) -> None:
        g = self._open_group
        if g is None or g["fut"] is not None:
            return
        stacked = (
            g["arrs"][0][None]
            if len(g["arrs"]) == 1
            else jnp.stack(g["arrs"])
        )
        # start the device->host copy WITHOUT blocking (and without a
        # fetch thread: device_get holds the GIL for the duration of the
        # transfer on this backend, which stalled the dispatch loop); the
        # drain's np.asarray then finds the data already host-side
        try:
            stacked.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass
        g["fut"] = stacked
        g["arrs"] = []  # release per-step device refs (stack holds data)
        self._open_group = None

    def flush(self):
        """Drain every in-flight :meth:`feed_device` step; returns their
        frames and settles ``pending_frame``."""
        return self._drain(len(self._pending_steps))

    def _drain(self, count: int):
        """Join the oldest ``count`` in-flight steps' prefetches (already
        in flight since dispatch time) and materialize their frames in
        stream order."""
        entries = self._pending_steps[:count]
        del self._pending_steps[:count]
        frames = []
        for entry in entries:
            g = entry[0]
            if g["fut"] is None:  # partial group still open: fetch it now
                assert g is self._open_group  # only the open group lacks a fut
                self._submit_group()
            if not isinstance(g["fut"], np.ndarray):
                g["fut"] = np.asarray(g["fut"])  # join the async copy
            frames += self._fetch_step(entry, g["fut"][entry[1]])
        return frames

    def _fetch_step(self, entry, packed: np.ndarray):
        """Materialize one fused step's frames from its fetched record."""
        _g, _idx, spec, buf_r, buf_i, r_cap = entry
        rec_w = 10 + 2 * len(spec)
        rec = packed[:, :rec_w]
        dec = np.ascontiguousarray(packed[:-1, rec_w:]).view(np.uint8)
        meta = rec[-1]
        rec = rec[:-1]
        res_len_in, keep2, _consumed, incomplete, tiny = meta[:5]
        lead = r_cap - int(res_len_in)
        base2 = self._residual_offset - lead
        self._residual_offset = base2 + int(keep2)
        if not tiny:
            self.pending_frame = bool(incomplete)
        bests = rec[:, 0]
        cfos = np.ascontiguousarray(rec[:, 1]).view(np.float32)
        accept = rec[:, 2].astype(bool)
        match_idx = rec[:, 3]
        # each candidate's dec row holds its MATCHED spec's decode bytes;
        # group rows per spec and unpack each group at its own width (the
        # per-candidate cfo is the scan's — the decode does not change it)
        spec_outs, spec_pos = [], []
        for s, key in enumerate(spec):
            rows = np.flatnonzero(accept & (match_idx == s))
            width = 16 + key[0]  # 14 + payload_len + 2 ok flags
            er = (
                np.ascontiguousarray(rec[rows, 10 + 2 * s : 12 + 2 * s])
                .view(np.float32)
                .reshape(len(rows), 2)
            )
            f32_s = np.column_stack([er, cfos[rows]])
            spec_outs.append(
                (
                    self._sync_for(*key),
                    _unpack_rx(dec[rows, :width], f32_s, key[0]),
                )
            )
            spec_pos.append({int(i): j for j, i in enumerate(rows)})
        frames = []
        fallback: dict[tuple, list[tuple[int, int]]] = {}
        acc_idx = np.flatnonzero(accept)  # iterate only accepted candidates
        for i in acc_idx[np.argsort(bests[acc_idx], kind="stable")]:
            off = int(bests[i])
            s = int(match_idx[i])
            if s >= 0:
                sync, out = spec_outs[s]
                j = spec_pos[s][int(i)]
                frames.append(
                    {
                        "offset": base2 + off,
                        "stats": sync._stats_from(out, j),
                        "header": out["headers"][j],
                        "payload": out["payloads"][j],
                    }
                )
                self._touch_spec(spec[s])
            else:
                # the scan's exact PHY header (rec cols 4..10); a
                # mismatched candidate's dec row may be window-clipped
                parsed = unpack_phy_header(rec[i, 4:10].astype(np.uint8))
                # accept implies a parseable header (phy_valid in-graph)
                fallback.setdefault(parsed, []).append((off, int(i)))
        if fallback:
            frames += self._decode_groups(buf_r, buf_i, fallback, cfos, base2)
            for key in fallback:
                self._touch_spec(key)
            frames.sort(key=lambda f: f["offset"])
        return frames

    def _touch_spec(self, key: tuple) -> None:
        """LRU update of the speculative-decode config history (cap 2)."""
        if self._spec_lru and self._spec_lru[-1] == key:
            return
        if key in self._spec_lru:
            self._spec_lru.remove(key)
        self._spec_lru.append(key)
        del self._spec_lru[:-2]
