#!/usr/bin/env python
"""Smoke test of the main path on one GPU, at real sizes.

    python chip_smoke.py          # every one-card phase
    python chip_smoke.py --four   # only the four-card phase (4 GPUs)

Phases (each raises on failure):

* sense->classify at 4096 cycles (21 M samples) through ``make_sense_fn``,
  with ``memory_analysis()`` of the compiled step, compared with the plain
  XLA graph at F32 ("highest") on the same input;
* the golden gate on a Markov-PU scene vs tests/golden_reference.py, for
  each precision name held to it;
* bf16 ingest (precision "default") vs f32 at the same size;
* 64-channel wideband detection through ``make_wideband_fn`` on a
  one-device mesh, 524,288 samples per channel, vs the numpy oracle on the
  leading segment;
* fixed-config OFDM block receive (256 frames) and adaptive streaming
  receive (the gate plus a 2,048-frame mixed burst), payloads intact;
* the in-process predictive_model.cfg scenario under phy_placement "host"
  and "device": no failed node, and the predictive SU decides.

``--four`` runs the 64-channel wideband pipeline on a (time=2, channel=2)
mesh and the sharded train step of models/distributed.py at
``WidebandConfig()`` widths, each against the same input on one device.

Exits non-zero when JAX finds no GPU.  The last line of standard output is
one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.utils.platform import enable_compile_cache

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

import chip_gates  # noqa: E402

# make_sense_fn vs the plain dense-DFT graph at F32 on random input, per
# precision name.  Spectrum (max error over the largest bin): F32 differs
# only in summation order (~5e-7 measured on the card), bf16_3x leaves ~3e-6,
# one bf16 pass ~2e-3.  Features square a band sum of 10-33 noise bins, so
# their relative error is larger: two F32 implementations (cuFFT and the
# dense matmul) already differ by 1.2e-4 on the card.
SPECTRUM_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 2e-2}
FEATURES_RTOL = {"highest": 1e-3, "high": 1e-3, "default": 2e-2}
# wideband at bf16_3x vs the float64 oracle: ~1e-5 relative on each DFT
# output, squared and averaged over a 128-sample cycle
WIDEBAND_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def phase_sense(cycles: int = 4096, precisions=("highest", "high", "default")) -> dict:
    """Sense->classify through make_sense_fn vs the plain XLA graph at F32."""
    from cognitive_radio_network_tpu.models import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu.signal.bands import band_features
    from cognitive_radio_network_tpu.signal.fft import averaged_magnitude_spectrum
    from cognitive_radio_network_tpu.signal.mlp import reference_weights
    from cognitive_radio_network_tpu.utils.platform import sense_fft_mode

    cfg0 = SenseConfig()
    a, n = cfg0.averaging, cfg0.fft_length
    rng = np.random.default_rng(0)
    xr = jnp.asarray(rng.standard_normal((cycles * a, n), dtype=np.float32))
    xi = jnp.asarray(rng.standard_normal((cycles * a, n), dtype=np.float32))
    params = reference_weights()
    ref_avg = jax.jit(
        lambda r, i: averaged_magnitude_spectrum(
            (r.reshape(-1, a, n), i.reshape(-1, a, n)),
            mode="dft_matmul",
            precision="highest",
        )
    )(xr, xi)
    ref_feats = np.asarray(band_features(ref_avg))
    results = {}
    for prec in precisions:
        cfg = dataclasses.replace(cfg0, precision=prec)
        fn = make_sense_fn(cfg)
        compiled = fn.lower((xr, xi), params).compile()
        mem = compiled.memory_analysis()
        out = compiled((xr, xi), params)
        feats = np.asarray(out["features"])
        assert feats.shape == (cycles, 4) and np.all(np.isfinite(feats))
        assert out["decision"].shape == (cycles,)
        err_avg = _rel_err(out["avg_spectrum"], ref_avg)
        err_f = float(np.max(np.abs(feats / ref_feats - 1)))
        tol_avg, tol_f = SPECTRUM_RTOL[prec], FEATURES_RTOL[prec]
        log(
            f"sense[{prec}] cycles={cycles} mode={sense_fft_mode(n)} "
            f"avg_rel_err={err_avg:.3e} (tol {tol_avg:g}) "
            f"feat_rel_err={err_f:.3e} (tol {tol_f:g}) "
            f"temp_bytes={getattr(mem, 'temp_size_in_bytes', None)} "
            f"arg_bytes={getattr(mem, 'argument_size_in_bytes', None)} "
            f"out_bytes={getattr(mem, 'output_size_in_bytes', None)}"
        )
        assert err_avg <= tol_avg and err_f <= tol_f, (prec, err_avg, err_f)
        results[prec] = {"avg_rel_err": err_avg, "feat_rel_err": err_f}
    return results


def phase_golden(cycles: int = 256, precisions=chip_gates.GOLDEN_PRECISIONS) -> dict:
    out = {}
    for prec in precisions:
        out[prec] = chip_gates.gate_sense_golden(cycles, prec)
        log(
            f"golden[{prec}] cycles={cycles} {json.dumps(out[prec])} "
            f"tol: features rtol {chip_gates.GOLDEN_RTOL_FEATURES:g}, outputs "
            f"atol {chip_gates.GOLDEN_ATOL_OUTPUTS:g}, decisions bit-equal"
        )
    return out


def phase_bf16(cycles: int = 4096) -> float:
    """bf16 planar ingest at precision "default" vs the f32 path."""
    from cognitive_radio_network_tpu.models import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu.signal.mlp import reference_weights

    cfg = SenseConfig()
    rng = np.random.default_rng(1)
    shape = (cycles * cfg.averaging, cfg.fft_length)
    xr = jnp.asarray(rng.standard_normal(shape, dtype=np.float32))
    xi = jnp.asarray(rng.standard_normal(shape, dtype=np.float32))
    params = reference_weights()
    want = np.asarray(make_sense_fn(cfg)((xr, xi), params)["features"])
    fn16 = make_sense_fn(dataclasses.replace(cfg, precision="default"))
    got = np.asarray(
        fn16((xr.astype(jnp.bfloat16), xi.astype(jnp.bfloat16)), params)["features"]
    )
    err = float(np.max(np.abs(got / want - 1)))
    tol = chip_gates.BF16_RTOL_FEATURES
    log(f"bf16_ingest cycles={cycles} feat_rel_err={err:.3e} tol={tol:g}")
    assert err <= tol, (err, tol)
    return err


def phase_wideband(t_chan: int = 524288, check_chan: int = 8192) -> float:
    """make_wideband_fn on a one-device mesh vs the numpy oracle on the
    leading ``check_chan`` samples per channel (the FIR starts from rest
    at the stream start, so the leading cycles stand alone)."""
    from cognitive_radio_network_tpu.parallel import MeshSpec, make_mesh
    from cognitive_radio_network_tpu.parallel.wideband import (
        WidebandConfig,
        make_wideband_fn,
    )

    cfg = WidebandConfig()
    m = cfg.num_channels
    rng = np.random.default_rng(2)
    planes = rng.standard_normal((t_chan * m, 2), dtype=np.float32)
    mesh = make_mesh(MeshSpec(), jax.devices()[:1])
    res = make_wideband_fn(mesh, cfg)(jnp.asarray(planes))
    energy = np.asarray(res["energy"])
    assert energy.shape == (t_chan // cfg.block_len, m)
    assert np.all(np.isfinite(energy))
    lead = check_chan * m
    want = chip_gates.wideband_energy_numpy(
        planes[:lead, 0], planes[:lead, 1], cfg.taps(), cfg
    )
    err = _rel_err(energy[: want.shape[0]], want)
    log(
        f"wideband M={m} samples/channel={t_chan} precision={cfg.precision} "
        f"lead_rel_err={err:.3e} tol={WIDEBAND_RTOL:g}"
    )
    assert err <= WIDEBAND_RTOL, (err, WIDEBAND_RTOL)
    return err


def phase_ofdm(frames: int = 256) -> None:
    chip_gates.gate_ofdm_decode(np.random.default_rng(3), frames)
    log(f"ofdm_block_receive frames={frames} payloads intact")


def adaptive_receive(rr, ri, cfg_a, frames: int, blocks: int = 4) -> list:
    """Stream a burst through StreamReceiver's pipelined device API."""
    from cognitive_radio_network_tpu.phy.framesync import StreamReceiver

    blk = rr.size // blocks
    srx = StreamReceiver(cfg_a, max_frames_per_block=frames // blocks + 8)
    got = []
    for i in range(blocks):
        sl = slice(i * blk, rr.size if i == blocks - 1 else (i + 1) * blk)
        got += srx.feed_device(
            jnp.asarray(rr[sl]), jnp.asarray(ri[sl]), threshold=0.2
        )
    return got + srx.flush()


def phase_adaptive(frames: int = 2048) -> None:
    chip_gates.gate_adaptive_stream(np.random.default_rng(5))
    rr, ri, pays, cfg_a = chip_gates.adaptive_burst(
        np.random.default_rng(6), frames
    )
    chip_gates.check_adaptive_frames(adaptive_receive(rr, ri, cfg_a, frames), pays)
    log(f"adaptive_stream gate ok; mixed burst frames={frames} payloads intact")


def phase_scenario(run_time: float = 2.0, placements=("host", "device")) -> dict:
    from cognitive_radio_network_tpu.runtime.config import load_scenario
    from cognitive_radio_network_tpu.runtime.controller import ScenarioRuntime

    out = {}
    for placement in placements:
        cfg = load_scenario(ROOT / "scenarios" / "predictive_model.cfg")
        cfg.run_time = run_time
        cfg.phy_placement = placement
        rt = ScenarioRuntime(cfg)
        t0 = time.perf_counter()
        rt.run()
        wall = time.perf_counter() - t0
        assert not rt.failed_nodes, (placement, rt.failed_nodes)
        decisions = len(getattr(rt.nodes[1].engine, "decisions", []))
        assert decisions > 0, f"predictive SU made no decisions ({placement})"
        out[placement] = decisions
        log(
            f"scenario predictive_model placement={placement} "
            f"sim_s={run_time} wall_s={wall:.1f} su_decisions={decisions}"
        )
    return out


def phase_four(t_chan: int = 524288, batch: int = 8, train_chan: int = 16384) -> dict:
    """Sharded vs one device: the 64-channel wideband pipeline on a
    (time=2, channel=2) mesh, and one sharded train step."""
    from cognitive_radio_network_tpu.models.distributed import make_sharded_train_step
    from cognitive_radio_network_tpu.parallel import MeshSpec, make_mesh
    from cognitive_radio_network_tpu.parallel.wideband import (
        WidebandConfig,
        make_wideband_fn,
    )

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devices)}")
    cfg = dataclasses.replace(WidebandConfig(), precision="highest")
    m = cfg.num_channels
    rng = np.random.default_rng(4)
    mesh4 = make_mesh(MeshSpec(time=2, channel=2), devices[:4])
    mesh1 = make_mesh(MeshSpec(), devices[:1])

    planes = jnp.asarray(rng.standard_normal((t_chan * m, 2), dtype=np.float32))
    r4 = make_wideband_fn(mesh4, cfg)(planes)
    r1 = make_wideband_fn(mesh1, cfg)(planes)
    e4, e1 = np.asarray(r4["energy"]), np.asarray(r1["energy"])
    # same F32 math, other summation order across the seams
    tol = 1e-5
    err_w = _rel_err(e4, e1)
    flips = int(np.sum(np.asarray(r4["occupied"]) != np.asarray(r1["occupied"])))
    log(
        f"four/wideband mesh=(time=2,channel=2) M={m} samples/channel={t_chan} "
        f"energy_rel_err={err_w:.3e} tol={tol:g} occupied_mismatch={flips}"
    )
    assert err_w <= tol and flips == 0, (err_w, flips)

    tcfg = WidebandConfig()
    c = train_chan // tcfg.block_len
    tplanes = jnp.asarray(
        rng.standard_normal((batch, train_chan * m, 2), dtype=np.float32)
    )
    labels = jnp.asarray(rng.integers(0, 2, (batch, c, m)).astype(np.float32))
    results = {}
    for name, mesh in (("four", mesh4), ("one", mesh1)):
        init_fn, step_fn = make_sharded_train_step(mesh, tcfg)
        state = init_fn(jax.random.key(0))
        state, loss = step_fn(state, tplanes, labels)
        results[name] = (float(loss), jax.tree.map(np.asarray, state.params))
    (l4, p4), (l1, p1) = results["four"], results["one"]
    err_p = max(
        _rel_err(a_, b_) for a_, b_ in zip(jax.tree.leaves(p4), jax.tree.leaves(p1))
    )
    # bf16_3x energies (~1e-5) feed a log-compressed MLP loss
    tol_t = 1e-4
    err_l = abs(l4 - l1) / abs(l1)
    log(
        f"four/train_step batch={batch} samples/channel={train_chan} M={m} "
        f"loss4={l4:.6f} loss1={l1:.6f} loss_rel_err={err_l:.3e} "
        f"param_rel_err={err_p:.3e} tol={tol_t:g}"
    )
    assert np.isfinite(l4) and err_l <= tol_t and err_p <= tol_t, (err_l, err_p)
    return {"wideband_rel_err": err_w, "loss_rel_err": err_l, "param_rel_err": err_p}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true", help="only the 4-card phase")
    args = ap.parse_args(argv)

    info = device_info()
    if info["platform"] != "gpu":
        print(f"no GPU found (JAX platform {info['platform']!r})", file=sys.stderr)
        return 2
    enable_compile_cache()
    log(card_line())
    log(f"jax {jax.__version__} platform={info['platform']} kind={info['kind']} count={info['count']}")
    if args.four:
        phases = [phase_four]
    else:
        phases = [
            phase_sense,
            phase_golden,
            phase_bf16,
            phase_wideband,
            phase_ofdm,
            phase_adaptive,
            phase_scenario,
        ]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"phase {phase.__name__} ok in {time.perf_counter() - t0:.1f} s")
    log(card_line())
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
