"""On-device correctness gates, shared by chip_smoke.py, bench.py and
`pytest -m gpu`.

Each gate runs a hot path on the default device (the GPU when one is
present) and asserts its output against an independent numpy oracle.  The
CPU suite cannot catch a GPU lowering or precision bug; these gates make
on-device correctness a first-class check, and the bench imports the same
helpers so such a bug aborts the benchmark instead of shipping a number.

Every gate takes its sizes as arguments, so the CPU suite runs the same
code at small sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Golden tolerances, per precision name (signal/fft.matmul).  The
# decisions must be bit-equal at every name listed; features and outputs
# carry the dot algorithm's rounding: F32 leaves ~1e-6, bf16_3x ~1e-5, both
# far inside 5e-3 / 2e-3.  One bf16 pass (~1e-2 relative on the band sums)
# is not held to the golden reference.
GOLDEN_RTOL_FEATURES = 5e-3
GOLDEN_ATOL_OUTPUTS = 2e-3
GOLDEN_PRECISIONS = ("highest", "high")
# bf16 ingest with one bf16 dot pass vs the f32 path: the inputs keep 8
# mantissa bits, and a band sum of 10-33 bins averages their rounding
BF16_RTOL_FEATURES = 2e-2


def wideband_energy_numpy(xr, xi, taps, cfg, history=None):
    """Independent numpy transliteration of the wideband energy math
    (polyphase depthwise FIR -> M-point DFT -> per-cycle mean power).

    ``history``: optional (hr, hi) wide samples that precede the stream;
    their last P-1 phase rows seed the FIR (the cross-shard state of the
    time-sharded pipeline) instead of rest-from-zero."""
    m = cfg.num_channels
    t = xr.size // m
    vr_in = xr.reshape(t, m).astype(np.float64)
    vi_in = xi.reshape(t, m).astype(np.float64)
    hf = taps[::-1].astype(np.float64)  # (P, M), flipped like _fir_rows
    p = hf.shape[0]
    if history is None:
        pre_r = pre_i = np.zeros((p - 1, m))
    else:
        pre_r = np.asarray(history[0], np.float64).reshape(-1, m)[-(p - 1) :]
        pre_i = np.asarray(history[1], np.float64).reshape(-1, m)[-(p - 1) :]
    ext_r = np.concatenate([pre_r, vr_in], axis=0)
    ext_i = np.concatenate([pre_i, vi_in], axis=0)
    vr = np.zeros((t, m))
    vi = np.zeros((t, m))
    for s in range(p):
        vr += hf[s] * ext_r[s : s + t]
        vi += hf[s] * ext_i[s : s + t]
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    wre, wim = np.cos(ang), np.sin(ang)
    yr = vr @ wre - vi @ wim
    yi = vr @ wim + vi @ wre
    power = yr**2 + yi**2
    return power.reshape(t // cfg.block_len, cfg.block_len, m).mean(axis=1)


def markov_scene(cycles: int, seed: int = 7):
    """A synthesized Markov-PU scene: (trace (C,), planes (C, A, N, 2))."""
    import jax

    from cognitive_radio_network_tpu.env import markov_pu_trace
    from cognitive_radio_network_tpu.env import scene as scene_mod
    from cognitive_radio_network_tpu.models import SenseConfig

    cfg = SenseConfig()
    trace = markov_pu_trace(jax.random.key(seed), cycles)
    powers = scene_mod.occupancy_to_powers(trace, 3, power=0.05)
    planes = jax.jit(
        scene_mod.synthesize_scene,
        static_argnums=(2,),
        static_argnames=("as_planes",),
    )(jax.random.key(seed + 1), powers, cfg.samples_per_cycle, as_planes=True)
    planes = np.asarray(planes).reshape(
        cycles, cfg.averaging, cfg.fft_length, 2
    )
    return np.asarray(trace), planes


def gate_sense_golden(cycles: int = 256, precision: str = "high") -> dict:
    """Sense->classify through make_sense_fn (the kernel where
    utils/platform selects it) vs the golden scalar transliteration
    (tests/golden_reference.py) on a Markov-PU scene: features to
    GOLDEN_RTOL_FEATURES, MLP outputs to GOLDEN_ATOL_OUTPUTS, decisions
    bit-equal.  Returns the worst errors seen."""
    import jax.numpy as jnp

    import golden_reference as gold
    from cognitive_radio_network_tpu.models import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu.signal.mlp import reference_weights

    cfg = SenseConfig(precision=precision)
    _, g = markov_scene(cycles)
    n = cfg.fft_length
    out = make_sense_fn(cfg)(
        (
            jnp.asarray(g[..., 0].reshape(-1, n)),
            jnp.asarray(g[..., 1].reshape(-1, n)),
        ),
        reference_weights(),
    )
    out = {k: np.asarray(v) for k, v in out.items()}
    feats_ref, outs_ref, decs_ref = gold.sense_classify_reference(
        g[..., 0] + 1j * g[..., 1]
    )
    np.testing.assert_allclose(
        out["features"], feats_ref, rtol=GOLDEN_RTOL_FEATURES
    )
    np.testing.assert_allclose(
        out["outputs"], outs_ref, atol=GOLDEN_ATOL_OUTPUTS
    )
    assert np.array_equal(out["decision"], decs_ref), (
        f"sense decisions diverge from the golden reference ({precision})"
    )
    return {
        "features_rel_err": float(np.max(np.abs(out["features"] / feats_ref - 1))),
        "outputs_abs_err": float(np.max(np.abs(out["outputs"] - outs_ref))),
        "decisions_equal": int(out["decision"].size),
    }


def ofdm_burst(rng, frames: int = 256, payload: int = 256, gap: int = 80):
    """A fixed-config OFDM burst: (rr, ri, headers, payloads, frame_len)."""
    from cognitive_radio_network_tpu.phy import OFDMFrameConfig, OFDMFrameGen

    ogen = OFDMFrameGen(OFDMFrameConfig(), payload)
    hdr = rng.integers(0, 256, (frames, 8)).astype(np.uint8)
    pays = rng.integers(0, 256, (frames, payload)).astype(np.uint8)
    fr = np.asarray(ogen.assemble(hdr, pays, as_planes=True))  # (F, L, 2)
    flen = fr.shape[1]
    n = frames * (flen + gap)
    rr = np.zeros(n, np.float32)
    ri = np.zeros(n, np.float32)
    for i in range(frames):
        s = i * (flen + gap)
        rr[s : s + flen] = fr[i, :, 0]
        ri[s : s + flen] = fr[i, :, 1]
    return rr, ri, hdr, pays


def gate_ofdm_decode(rng=None, frames: int = 256):
    """One-dispatch fixed-config OFDM block receive decodes every frame of
    a synthetic burst with payloads intact.  Returns the device-resident
    block (rr, ri, n_valid, rx_fn, F, n_link) so the bench can reuse it."""
    import jax.numpy as jnp

    from cognitive_radio_network_tpu.phy import OFDMFrameConfig, OFDMFrameSync

    rng = rng or np.random.default_rng(0)
    opay = 256  # reference packet size (include/crts.hpp:192-194)
    rr, ri, _, opays = ofdm_burst(rng, frames, opay)
    n_link = rr.size
    orr_d, ori_d = jnp.asarray(rr), jnp.asarray(ri)
    nvalid_d = jnp.int32(n_link)
    rxfn = OFDMFrameSync(OFDMFrameConfig(), opay).rx_block_fn(k=frames)
    bests, peaks, cfos, oout, ok = rxfn(orr_d, ori_d, nvalid_d)
    okh = np.asarray(ok)
    order = np.argsort(np.asarray(bests), kind="stable")
    got = np.asarray(oout["payloads"])[order][okh[order]]
    assert okh.sum() == frames and np.array_equal(got, opays), (
        "ofdm link decode failed"
    )
    return orr_d, ori_d, nvalid_d, rxfn, frames, n_link


def gate_adaptive_stream(rng=None) -> None:
    """The fused adaptive stream step (phy/framesync.py::_stream_step_graph)
    on the device: a mixed-config burst with a block-straddling frame
    through process_device — in-graph candidate resolution, speculative
    dual-spec decode, device-resident residual carry, and the packed
    single-array fetch — with payloads intact."""
    import jax.numpy as jnp

    from cognitive_radio_network_tpu.phy import OFDMFrameConfig, OFDMFrameGen
    from cognitive_radio_network_tpu.phy.framesync import StreamReceiver

    rng = rng or np.random.default_rng(5)
    cfg_a = OFDMFrameConfig()
    cfg_b = dataclasses.replace(cfg_a, mod_scheme="qam16", fec0="none")
    gen_a = OFDMFrameGen(cfg_a, 64)
    gen_b = OFDMFrameGen(cfg_b, 48)
    f = 3
    ha = rng.integers(0, 256, (f, 8)).astype(np.uint8)
    pa = rng.integers(0, 256, (f, 64)).astype(np.uint8)
    hb = rng.integers(0, 256, (f, 8)).astype(np.uint8)
    pb = rng.integers(0, 256, (f, 48)).astype(np.uint8)
    pl_a = np.asarray(gen_a.assemble(ha, pa, as_planes=True))
    pl_b = np.asarray(gen_b.assemble(hb, pb, as_planes=True))
    ia = (pl_a[..., 0] + 1j * pl_a[..., 1]).astype(np.complex64)
    ib = (pl_b[..., 0] + 1j * pl_b[..., 1]).astype(np.complex64)
    n = 16000
    stream = 0.003 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ).astype(np.complex64)
    pos, placed = 60, []
    for k in range(2 * f):
        frame = ia[k // 2] if k % 2 == 0 else ib[k // 2]
        if pos + len(frame) + 50 >= n:
            break
        stream[pos : pos + len(frame)] += frame
        placed.append((pos, frame))
        pos += len(frame) + 911  # blocks of 2048 -> straddlers
    rx = StreamReceiver(cfg_a, max_frames_per_block=8)
    frames = []
    blk = 2048
    for s in range(0, n, blk):
        seg = stream[s : s + blk]
        frames += rx.process_device(
            jnp.asarray(seg.real.copy()), jnp.asarray(seg.imag.copy())
        )
    assert len(frames) == len(placed), (len(frames), len(placed))
    pays = {64: list(pa), 48: list(pb)}
    for fr, (off, _f) in zip(frames, placed):
        assert abs(fr["offset"] - off) <= 2, (fr["offset"], off)
        assert fr["stats"].payload_valid
        want = pays[len(fr["payload"])].pop(0)
        np.testing.assert_array_equal(fr["payload"], want)


def adaptive_burst(rng, frames: int = 2048, payload: int = 256, gap: int = 512):
    """A mixed-config burst alternating qam4/h128 and qam16/none frames:
    (rr, ri, payloads (F, payload), cfg_a).  Assembled on the host CPU
    backend: the tx side is not what the receive path is measured on."""
    import jax

    from cognitive_radio_network_tpu.phy import OFDMFrameConfig, OFDMFrameGen

    cfg_a = OFDMFrameConfig()
    cfg_b = dataclasses.replace(cfg_a, mod_scheme="qam16", fec0="none")
    hdr = rng.integers(0, 256, (frames, 8)).astype(np.uint8)
    pays = rng.integers(0, 256, (frames, payload)).astype(np.uint8)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        fr_a = np.asarray(
            OFDMFrameGen(cfg_a, payload).assemble(
                hdr[0::2], pays[0::2], as_planes=True
            )
        )
        fr_b = np.asarray(
            OFDMFrameGen(cfg_b, payload).assemble(
                hdr[1::2], pays[1::2], as_planes=True
            )
        )
    step_a = fr_a.shape[1] + gap
    step_b = fr_b.shape[1] + gap
    n = (frames // 2) * (step_a + step_b)
    rr = np.zeros(n, np.float32)
    ri = np.zeros(n, np.float32)
    pos = 0
    for i in range(frames // 2):
        for fr, step in ((fr_a, step_a), (fr_b, step_b)):
            rr[pos : pos + fr.shape[1]] = fr[i, :, 0]
            ri[pos : pos + fr.shape[1]] = fr[i, :, 1]
            pos += step
    return rr, ri, pays, cfg_a


def check_adaptive_frames(got: list, pays: np.ndarray) -> None:
    """Every frame of an :func:`adaptive_burst` decoded, intact, in order,
    with the alternating modulation carried by each frame's header."""
    frames = pays.shape[0]
    assert len(got) == frames, (len(got), frames)
    assert np.array_equal(np.stack([f["payload"] for f in got]), pays), (
        "adaptive decode mismatch"
    )
    assert all(f["stats"].payload_valid for f in got)
    mods = [f["stats"].mod_scheme for f in got]
    assert mods[0::2] == ["qam4"] * (frames // 2)
    assert mods[1::2] == ["qam16"] * (frames // 2)
