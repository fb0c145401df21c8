"""OFDM frame generator — the ``ofdmflexframegen`` capability, batched.

Frame format (time domain), for M subcarriers / CP-length C:

    [ S0 | S0 | S1+CP | header symbols... | payload symbols... ]

* **S0** (x2): short sync symbol — QPSK PRBS on every 2nd active subcarrier,
  giving half-symbol time periodicity for Schmidl&Cox-style detection and
  coarse CFO estimation (replaces liquid's S0 plan).
* **S1**: full known QPSK PRBS symbol (with CP) for one-shot channel
  estimation (replaces liquid's S1/long sequence).
* **header**: 8 user bytes (the reference packs frame number + type + 6
  control-info bytes here, src/extensible_cognitive_radio.cpp:893-896) plus a
  6-byte internal PHY header [payload_len:2 | mod | fec0 | fec1 | crc] so the
  receiver adapts per frame (liquid's ofdmflexframe carries the same info in
  its internal header) + CRC-32, Hamming(12,8) FEC, BPSK — fixed robust
  scheme, like liquid's internal header coding.
* **payload**: bytes + CRC + fec0 + fec1 (outer), modulated at the
  configured scheme.  Defaults mirror the ECR defaults: 32 subcarriers,
  cp 16, taper 4, QAM4, CRC-32, Hamming(12,8)+none
  (src/extensible_cognitive_radio.cpp:52-56, :100-104).

Data/pilot symbols carry per-symbol BPSK PRBS pilots for common-phase
tracking.  A raised-cosine taper of ``taper_len`` samples is applied across
symbol boundaries (liquid's tapered windowing).

Host numpy handles the bit-plumbing (CRC/FEC encode — control-plane work);
modulation + IFFT are batched jnp, so frame synthesis can run on-device for
fixture generation at scale.  All shapes are static given (config,
payload_len).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.phy import crc as crc_mod
from cognitive_radio_network_tpu.phy import fec as fec_mod
from cognitive_radio_network_tpu.phy import modem, subcarriers
from cognitive_radio_network_tpu.phy.bits import pack_bits, unpack_bits
from cognitive_radio_network_tpu.signal.msequence import MSequence

__all__ = [
    "OFDMFrameConfig",
    "OFDMFrameGen",
    "gen_for",
    "pack_phy_header",
    "unpack_phy_header",
]

HEADER_BYTES = 8  # user header bytes (ECR frame num/type + control info)
PHY_HEADER_BYTES = 6  # internal: payload_len(2, LE) | mod | fec0 | fec1 | crc
TOTAL_HEADER_BYTES = HEADER_BYTES + PHY_HEADER_BYTES
_HEADER_CRC = "crc32"
_HEADER_FEC = "h128"
_HEADER_MOD = "bpsk"


def pack_phy_header(cfg: "OFDMFrameConfig", payload_len: int) -> np.ndarray:
    from cognitive_radio_network_tpu.phy import crc as _crc, fec as _fec

    return np.array(
        [
            payload_len & 0xFF,
            (payload_len >> 8) & 0xFF,
            modem.SCHEMES.index(cfg.mod_scheme),
            _fec.SCHEMES.index(cfg.fec0),
            _fec.SCHEMES.index(cfg.fec1),
            _crc.SCHEMES.index(cfg.crc_scheme),
        ],
        np.uint8,
    )


def unpack_phy_header(phy: np.ndarray):
    """-> (payload_len, mod, fec0, fec1, crc) or None if ids out of range."""
    from cognitive_radio_network_tpu.phy import crc as _crc, fec as _fec

    payload_len = int(phy[0]) | (int(phy[1]) << 8)
    try:
        return (
            payload_len,
            modem.SCHEMES[int(phy[2])],
            _fec.SCHEMES[int(phy[3])],
            _fec.SCHEMES[int(phy[4])],
            _crc.SCHEMES[int(phy[5])],
        )
    except IndexError:
        return None


@dataclasses.dataclass(frozen=True)
class OFDMFrameConfig:
    num_subcarriers: int = 32
    cp_len: int = 16
    taper_len: int = 4
    mod_scheme: str = "qam4"
    crc_scheme: str = "crc32"
    fec0: str = "h128"
    fec1: str = "none"
    subcarrier_alloc: tuple[int, ...] | None = None  # None -> default_alloc

    def alloc(self) -> np.ndarray:
        if self.subcarrier_alloc is not None:
            return np.asarray(self.subcarrier_alloc, np.uint8)
        return subcarriers.default_alloc(self.num_subcarriers)

    @property
    def symbol_len(self) -> int:
        return self.num_subcarriers + self.cp_len


def _prbs_qpsk(n: int, seed: int) -> np.ndarray:
    ms = MSequence(m=11, init=seed)
    re = np.array([2 * ms.advance() - 1 for _ in range(n)], np.float32)
    im = np.array([2 * ms.advance() - 1 for _ in range(n)], np.float32)
    return ((re + 1j * im) / np.sqrt(2)).astype(np.complex64)


def _prbs_bpsk(n: int, seed: int) -> np.ndarray:
    ms = MSequence(m=11, init=seed)
    return np.array([2 * ms.advance() - 1 for _ in range(n)], np.float32).astype(
        np.complex64
    )


@functools.lru_cache(maxsize=32)
def pilot_sequence(num_symbols: int, n_pilots: int) -> np.ndarray:
    """Deterministic per-(symbol, pilot) BPSK sequence shared by gen and sync."""
    return _prbs_bpsk(num_symbols * max(n_pilots, 1), seed=0x2AA).reshape(
        num_symbols, -1
    )


class OFDMFrameGen:
    """Stateless batched frame assembler for a fixed config + payload length."""

    def __init__(self, cfg: OFDMFrameConfig, payload_len: int):
        self.cfg = cfg
        self.payload_len = payload_len
        m = cfg.num_subcarriers
        alloc = cfg.alloc()
        self.alloc = alloc
        self.data_idx = np.flatnonzero(alloc == subcarriers.SC_DATA)
        self.pilot_idx = np.flatnonzero(alloc == subcarriers.SC_PILOT)
        self.active_idx = np.flatnonzero(alloc != subcarriers.SC_NULL)
        if len(self.data_idx) == 0:
            raise ValueError("allocation has no data subcarriers")

        # --- preamble construction (frequency domain, unshifted) ---
        s0 = np.zeros(m, np.complex64)
        # S0 occupies only EVEN subcarrier indices so its time-domain signal
        # is periodic with period M/2 — the property the Schmidl&Cox
        # autocorrelation detector relies on.
        s0_act = self.active_idx[self.active_idx % 2 == 0]
        # sqrt(2) boost keeps S0 at the same time-domain power with half the
        # occupied bins.
        s0[s0_act] = _prbs_qpsk(len(s0_act), seed=0x5A5 & 0x7FF) * np.sqrt(2)
        self.S0_freq = s0
        s1 = np.zeros(m, np.complex64)
        s1[self.active_idx] = _prbs_qpsk(len(self.active_idx), seed=0x3C3)
        self.S1_freq = s1

        self.S0_time = np.fft.ifft(s0) * np.sqrt(m)  # no CP, periodic by design
        s1_time = np.fft.ifft(s1) * np.sqrt(m)
        self.S1_time = np.concatenate([s1_time[-cfg.cp_len :], s1_time])

        # --- sizing ---
        hdr_enc_bytes = fec_mod.encoded_length(
            _HEADER_FEC, TOTAL_HEADER_BYTES + crc_mod.crc_sizes(_HEADER_CRC)
        )
        self.n_header_bits = hdr_enc_bytes * 8
        self.n_header_syms = -(-self.n_header_bits // len(self.data_idx))

        enc0 = fec_mod.encoded_length(
            cfg.fec0, payload_len + crc_mod.crc_sizes(cfg.crc_scheme)
        )
        self.payload_enc_bytes = fec_mod.encoded_length(cfg.fec1, enc0)
        bps = modem.bits_per_symbol(cfg.mod_scheme)
        total_mod_syms = -(-self.payload_enc_bytes * 8 // bps)
        self.n_payload_syms = -(-total_mod_syms // len(self.data_idx))
        self.bps = bps

        self.num_symbols = self.n_header_syms + self.n_payload_syms
        self.frame_len = (
            2 * m  # two S0 symbols, no CP
            + (m + cfg.cp_len)  # S1
            + self.num_symbols * (m + cfg.cp_len)
        )
        # per-symbol pilot PRBS (BPSK), fixed across frames
        self.pilots = pilot_sequence(self.num_symbols, len(self.pilot_idx))

    # ----- host-side bit plumbing -----

    def encode_header(self, header: np.ndarray) -> np.ndarray:
        """8 user header bytes -> coded bits (n_header_bits,), with the
        internal PHY header (payload_len/mod/fec/crc of this generator)
        appended before coding."""
        header = np.asarray(header, np.uint8)
        if header.shape != (HEADER_BYTES,):
            raise ValueError(f"header must be {HEADER_BYTES} bytes")
        full = np.concatenate([header, pack_phy_header(self.cfg, self.payload_len)])
        with_crc = np.concatenate([full, crc_mod.crc_generate(_HEADER_CRC, full)])
        return unpack_bits(fec_mod.encode(_HEADER_FEC, with_crc))

    def encode_payload(self, payload: np.ndarray) -> np.ndarray:
        """payload bytes -> coded bits (payload_enc_bytes*8,)."""
        payload = np.asarray(payload, np.uint8)
        if payload.shape != (self.payload_len,):
            raise ValueError(f"payload must be {self.payload_len} bytes")
        with_crc = np.concatenate(
            [payload, crc_mod.crc_generate(self.cfg.crc_scheme, payload)]
        )
        return unpack_bits(fec_mod.encode(self.cfg.fec1, fec_mod.encode(self.cfg.fec0, with_crc)))

    def encode_header_batch(self, headers: np.ndarray) -> np.ndarray:
        """Batched encode_header: (B, 8) -> coded bits (B, n_header_bits)."""
        headers = np.asarray(headers, np.uint8)
        phy = pack_phy_header(self.cfg, self.payload_len)
        full = np.concatenate(
            [headers, np.tile(phy, (headers.shape[0], 1))], axis=1
        )
        with_crc = np.concatenate(
            [full, crc_mod.crc_generate_batch(_HEADER_CRC, full)], axis=1
        )
        return np.unpackbits(
            fec_mod.encode_batch(_HEADER_FEC, with_crc), axis=-1
        )

    def encode_payload_batch(self, payloads: np.ndarray) -> np.ndarray:
        """Batched encode_payload: (B, P) -> coded bits (B, n_bits)."""
        payloads = np.asarray(payloads, np.uint8)
        with_crc = np.concatenate(
            [payloads, crc_mod.crc_generate_batch(self.cfg.crc_scheme, payloads)],
            axis=1,
        )
        return np.unpackbits(
            fec_mod.encode_batch(
                self.cfg.fec1, fec_mod.encode_batch(self.cfg.fec0, with_crc)
            ),
            axis=-1,
        )

    # ----- device-side synthesis -----

    def assemble(
        self, headers: np.ndarray, payloads: np.ndarray, *, as_planes: bool = False
    ):
        """Batched frames: headers (B, 8), payloads (B, P) -> IQ (B, frame_len).

        Returns complex64 (B, frame_len) or float32 planes (B, frame_len, 2).
        """
        headers = np.atleast_2d(np.asarray(headers, np.uint8))
        payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
        hdr_bits = self.encode_header_batch(headers)
        pay_bits = self.encode_payload_batch(payloads)
        if as_planes:
            # planes come out of ONE jitted graph: no complex64 ever crosses
            # the jit boundary (a portability hazard, see signal/iq.py)
            return self._assemble_planes_jit(
                jnp.asarray(hdr_bits), jnp.asarray(pay_bits)
            )
        return self._assemble_jit(jnp.asarray(hdr_bits), jnp.asarray(pay_bits))

    @functools.cached_property
    def _assemble_jit(self):
        cfg = self.cfg
        m = cfg.num_subcarriers
        cp = cfg.cp_len
        nd = len(self.data_idx)
        # keep constants as NUMPY: eagerly-created complex device arrays
        # would need a device->host fetch when embedded as jit constants —
        # numpy constants embed without any transfer
        data_idx = np.asarray(self.data_idx)
        pilot_idx = np.asarray(self.pilot_idx)
        pilots = np.asarray(self.pilots)
        s0_t = np.asarray(self.S0_time)
        s1_t = np.asarray(self.S1_time)
        taper = np.asarray(_taper_window(cfg.taper_len))

        def assemble(hdr_bits, pay_bits):
            bdim = hdr_bits.shape[0]
            # header: BPSK bits -> symbols padded to fill header OFDM symbols
            hpad = self.n_header_syms * nd - hdr_bits.shape[1]
            hsyms = jnp.pad(hdr_bits, ((0, 0), (0, hpad))).astype(jnp.int32)
            hpoints = modem.modulate(_HEADER_MOD, hsyms)

            # payload: group bits into mod symbols
            bits = pay_bits
            ppad_bits = self.n_payload_syms * nd * self.bps - bits.shape[1]
            bits = jnp.pad(bits, ((0, 0), (0, ppad_bits)))
            weights = (1 << jnp.arange(self.bps - 1, -1, -1, dtype=jnp.int32)).astype(
                jnp.int32
            )
            psyms = jnp.sum(
                bits.reshape(bdim, -1, self.bps).astype(jnp.int32) * weights, axis=-1
            )
            ppoints = modem.modulate(cfg.mod_scheme, psyms)

            points = jnp.concatenate(
                [
                    hpoints.reshape(bdim, self.n_header_syms, nd),
                    ppoints.reshape(bdim, self.n_payload_syms, nd),
                ],
                axis=1,
            )  # (B, num_symbols, nd)

            # frequency-domain grid
            x = jnp.zeros((bdim, self.num_symbols, m), jnp.complex64)
            x = x.at[:, :, data_idx].set(points)
            if len(self.pilot_idx):
                x = x.at[:, :, pilot_idx].set(
                    jnp.broadcast_to(pilots, (bdim, *pilots.shape))
                )
            t = jnp.fft.ifft(x, axis=-1) * np.sqrt(m)
            with_cp = jnp.concatenate([t[..., -cp:], t], axis=-1)
            if cfg.taper_len > 0:
                # Rising ramp over the head of the CP only: smooths symbol
                # transitions for spectral containment while leaving every
                # useful sample untouched (the receiver discards the CP, so
                # this is demod-transparent as long as channel delay spread
                # stays under cp_len - taper_len).
                w = jnp.concatenate(
                    [taper, jnp.ones(m + cp - cfg.taper_len)]
                ).astype(jnp.complex64)
                with_cp = with_cp * w
            body = with_cp.reshape(bdim, -1)
            pre = jnp.concatenate(
                [jnp.asarray(s0_t), jnp.asarray(s0_t), jnp.asarray(s1_t)]
            )
            return jnp.concatenate(
                [jnp.broadcast_to(pre, (bdim, pre.shape[0])), body], axis=-1
            )

        return jax.jit(assemble)

    @functools.cached_property
    def _assemble_planes_jit(self):
        body = self._assemble_jit

        def planes(hdr_bits, pay_bits):
            iq = body(hdr_bits, pay_bits)
            return jnp.stack([jnp.real(iq), jnp.imag(iq)], axis=-1).astype(
                jnp.float32
            )

        return jax.jit(planes)


@functools.lru_cache(maxsize=512)
def gen_for(cfg: OFDMFrameConfig, payload_len: int) -> OFDMFrameGen:
    """Process-wide OFDMFrameGen cache.

    Identically-configured radios MUST share one generator instance so its
    cached jitted graphs (assembly here, demod/decode in phy/framesync.py)
    compile once per process, not once per radio — the reference runs up to
    48 node processes (include/crts.hpp:189), and a 48-node simulation with
    per-instance compilation recompiles the same graphs dozens of times.
    OFDMFrameGen is stateless, so sharing is safe."""
    return OFDMFrameGen(cfg, payload_len)


def _taper_window(taper_len: int) -> jnp.ndarray:
    if taper_len == 0:
        return jnp.ones((0,))
    n = jnp.arange(taper_len) + 0.5
    return jnp.sin(0.5 * jnp.pi * n / taper_len) ** 2
