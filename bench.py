#!/usr/bin/env python
"""Benchmark: sustained sense->classify throughput (MSamples/s per GPU).

Measures the BASELINE.json headline metric — the fused 3-channel
512-pt-FFT x10-average -> band-energy -> MLP -> decision pipeline
(the reference's CE_Predictive_Node sensing chain, CE_Predictive_Node.cpp:127-289)
on one GPU, batched over sense cycles — and beside it the wideband
detector, the OFDM receive paths and the scenario runtime.

    python bench.py [cycles]      # default 4096 cycles per dispatch

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "MSamples/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "extra": {...}}
vs_baseline is against the target of 100 MSamples/s per device
(BASELINE.md "Target: sustained sense->classify throughput"); the reference's
implied real-time bound is 13 MSamples/s on a CPU (predictive_model.cfg:76).

Every device-timed section ends in ``jax.block_until_ready``, runs >= 3
trials and reports the MEDIAN, with the min/max spread in ``extra``.
Exits non-zero when JAX finds no GPU.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.models import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu.signal.mlp import reference_weights
from cognitive_radio_network_tpu.utils.platform import enable_compile_cache

ROOT = Path(__file__).resolve().parent
TARGET_MSPS = 100.0
TRIALS = 3


def _median_trials(run_once, trials: int = TRIALS):
    """Median-of-trials wrapper for device-timed sections.

    ``run_once`` returns either a value or (value, side_dict); returns
    (median, min, max, side-of-the-MEDIAN-trial) so side-channel figures
    (reps, frames/s) stay consistent with the headline value."""
    results = [run_once() for _ in range(trials)]
    vals = [r[0] if isinstance(r, tuple) else r for r in results]
    mid = sorted(range(trials), key=lambda i: vals[i])[trials // 2]
    side = results[mid][1] if isinstance(results[mid], tuple) else None
    return float(vals[mid]), float(min(vals)), float(max(vals)), side


def _rate_trial(fn, args, samples: int, min_s: float = 1.0, reps: int = 4):
    """Dispatch ``fn(*args)`` back to back until ``min_s`` elapses; returns
    (MSamples/s, {"reps"}) with ``samples`` per call."""
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - t0
        if elapsed > min_s or reps >= 4096:
            return reps * samples / elapsed / 1e6, {"reps": reps}
        reps *= 2


def main() -> int:
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_gates
    from chip_smoke import adaptive_receive, card_line, device_info

    info = device_info()
    if info["platform"] != "gpu":
        print(f"no GPU found (JAX platform {info['platform']!r})", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_line()
    print(card, flush=True)

    cfg = SenseConfig()
    cycles = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n = cycles * cfg.samples_per_cycle

    fn = make_sense_fn(cfg)
    params = reference_weights()

    rng = np.random.default_rng(0)
    # planar float32 I/Q (xr, xi), buffers-flat 2D (C*A, N) — the
    # framework's preferred device layout (see signal/iq.py)
    host_xr = rng.standard_normal(
        (cycles * cfg.averaging, cfg.fft_length), dtype=np.float32
    )
    host_xi = rng.standard_normal(
        (cycles * cfg.averaging, cfg.fft_length), dtype=np.float32
    )
    iq = (jnp.asarray(host_xr), jnp.asarray(host_xi))
    jax.block_until_ready(fn(iq, params))

    # correctness gate: a lowering or precision bug aborts the bench
    # instead of shipping a throughput number
    chip_gates.gate_sense_golden(256, cfg.precision)

    msps, msps_lo, msps_hi, sside = _median_trials(
        lambda: _rate_trial(fn, (iq, params), n)
    )
    reps = sside["reps"]

    # per-block latency: one 64-cycle block (a 25 ms radio block at the
    # reference's cadence) dispatched and waited for, one at a time
    lat_cycles = 64
    iq_lat = (
        jnp.asarray(host_xr[: lat_cycles * cfg.averaging]),
        jnp.asarray(host_xi[: lat_cycles * cfg.averaging]),
    )
    for _ in range(8):
        jax.block_until_ready(fn(iq_lat, params))
    lat = []
    for _ in range(400):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(iq_lat, params))
        lat.append(time.perf_counter() - t0)
    p50_block_ms = float(np.percentile(lat, 50) * 1e3)
    p99_block_ms = float(np.percentile(lat, 99) * 1e3)

    # 64-channel wideband energy detect (BASELINE config 5's per-device
    # building block) through make_wideband_fn on a one-device mesh, at a
    # streaming block size of 524,288 samples per channel
    from cognitive_radio_network_tpu.parallel import MeshSpec, make_mesh
    from cognitive_radio_network_tpu.parallel.wideband import (
        WidebandConfig,
        make_wideband_fn,
    )

    wcfg = WidebandConfig()
    t_chan = 524288
    wn = t_chan * wcfg.num_channels
    wfn = make_wideband_fn(make_mesh(MeshSpec(), jax.devices()[:1]), wcfg)
    wplanes = (
        jnp.asarray(rng.standard_normal(wn, dtype=np.float32)),
        jnp.asarray(rng.standard_normal(wn, dtype=np.float32)),
    )
    jax.block_until_ready(wfn(wplanes))
    wideband_msps, wideband_lo, wideband_hi, _ = _median_trials(
        lambda: _rate_trial(wfn, (wplanes,), wn)
    )

    # OFDM link: full-rate receive on the fused fixed-config path — top-K
    # Schmidl&Cox detect + gather + demod + FEC + CRC in ONE dispatch per
    # block (phy/framesync.py::_receive_block_graph).  The reference's
    # implied bound is sustaining 13 MS/s *including* frame sync on a CPU
    # (BASELINE.md; scenarios/predictive_model.cfg:76).
    orr_d, ori_d, nvalid_d, rxfn, F, n_link = chip_gates.gate_ofdm_decode(rng)

    def ofdm_trial():
        rate, _ = _rate_trial(rxfn, (orr_d, ori_d, nvalid_d), n_link)
        return rate, {"fps": rate * 1e6 / n_link * F}

    ofdm_msps, ofdm_lo, ofdm_hi, oside = _median_trials(ofdm_trial)
    ofdm_fps = oside["fps"]

    # Adaptive link: the liquid-equivalent STREAMING receiver — the path
    # that replaces ofdmflexframesync_execute per SURVEY §2.1
    # (src/extensible_cognitive_radio.cpp:1299-1366).  A mixed-config burst
    # (alternating qam4/h128 and qam16/none payload configs) streams
    # through the fused one-dispatch-per-block step
    # (phy/framesync.py::_stream_step_graph) via the pipelined
    # feed_device/flush API; the figure includes delivery of every payload
    # byte to the host.
    F_ad = 2048
    arr, ari, apays, acfg = chip_gates.adaptive_burst(rng, F_ad)
    n_ad = arr.size
    # correctness gate before timing (the warm pass also compiles)
    chip_gates.check_adaptive_frames(adaptive_receive(arr, ari, acfg, F_ad), apays)

    def adaptive_trial():
        passes = 2
        t0 = time.perf_counter()
        for _ in range(passes):
            got = adaptive_receive(arr, ari, acfg, F_ad)
        ael = time.perf_counter() - t0
        chip_gates.check_adaptive_frames(got, apays)
        return passes * n_ad / ael / 1e6, {"fps": passes * F_ad / ael}

    adaptive_msps, adaptive_lo, adaptive_hi, aside = _median_trials(
        adaptive_trial
    )
    adaptive_fps = aside["fps"]

    # bf16 IQ ingest + single-pass bf16 dots (precision "default") — half
    # the input bytes
    fn16 = make_sense_fn(dataclasses.replace(cfg, precision="default"))
    iq16 = (iq[0].astype(jnp.bfloat16), iq[1].astype(jnp.bfloat16))
    jax.block_until_ready(fn16(iq16, params))
    msps16, msps16_lo, msps16_hi, _ = _median_trials(
        lambda: _rate_trial(fn16, (iq16, params), n)
    )

    # Scenario runtime: simulated seconds per wall second for the reference's
    # headline scenario (scenarios/predictive_model.cfg — random-hopping PU +
    # CE_Predictive_Node SU in a 13 MS/s medium).  >= 1.0 means the full
    # framework (traffic, frame assembly, medium, frame sync, engines)
    # sustains the reference's real-time bound.  The link PHY runs where
    # ScenarioConfig.phy_placement says (see runtime/controller.py).
    from cognitive_radio_network_tpu.runtime.config import load_scenario
    from cognitive_radio_network_tpu.runtime.controller import ScenarioRuntime

    scn = ROOT / "scenarios" / "predictive_model.cfg"
    scfg = load_scenario(scn)
    scfg.run_time = 0.5  # warmup: compile the PHY graphs
    wrt = ScenarioRuntime(scfg)
    wrt.run()
    assert not wrt.failed_nodes, f"scenario nodes failed: {wrt.failed_nodes}"
    scfg = load_scenario(scn)
    scfg.run_time = 12.0
    srt = ScenarioRuntime(scfg)
    srt.run()
    # a dead node would make the factor measure an empty scenario, and the
    # predictive SU must have produced decisions
    assert not srt.failed_nodes, f"scenario nodes failed: {srt.failed_nodes}"
    su_decisions = getattr(srt.nodes[1].engine, "decisions", [])
    assert len(su_decisions) > 0, "predictive SU made no decisions"
    realtime_factor = srt.steady_t / max(srt.steady_wall_time_s, 1e-9)

    # Distributed (netctl) mode: the reference's ACTUAL topology — a
    # controller process + one OS process per node, lockstep medium blocks
    # over the TCP star (src/crts_cognitive_radio.cpp:818-915).  Node
    # processes run their PHY/engines on the host CPU
    # (phy_placement="host", launched with JAX_PLATFORMS=cpu), so they never
    # open the GPU.  Steady-state factor excludes the first quarter, where
    # node processes jit-compile.
    from cognitive_radio_network_tpu.runtime.netctl import NetController

    # Warm run first: node processes fill the persistent compilation cache
    # so the timed run measures steady state.  Then 40 sim-seconds timed.
    wcfg_d = load_scenario(scn)
    wcfg_d.run_time = 2.0
    NetController(wcfg_d, port=47489, start_pad_s=1.0).run()
    dcfg = load_scenario(scn)
    dcfg.run_time = 40.0
    dctl = NetController(dcfg, port=47490, start_pad_s=1.0)
    dctl.run()
    dist_realtime_factor = dctl.steady_t / max(dctl.steady_wall_time_s, 1e-9)

    # 8-node distributed mode: 3 FDD pairs + 2 interferers as 8 OS
    # processes through the TCP star (scenarios/eight_node.cfg;
    # include/crts.hpp:189 allows 48).  Two numbers: the AGGREGATE realtime
    # factor on this host (all 8 node processes share its cores), and the
    # PER-NODE margin max(node CPU seconds)/sim seconds, the real-time
    # criterion under the reference's deployment of one host per node
    # process (src/crts_controller.cpp:404-421): margin < 1.0 means every
    # node individually sustains real time on a single core.
    def _node_margin(ctl, default_sim):
        node_cpu = [s.get("cpu_time_s", 0.0) for s in ctl.summaries.values()]
        sim_s = max(
            (s.get("sim_time_s", 0.0) for s in ctl.summaries.values()),
            default=default_sim,
        )
        return (
            max(node_cpu) / max(sim_s, 1e-9) if node_cpu else float("nan")
        )

    scn8 = ROOT / "scenarios" / "eight_node.cfg"
    wcfg8 = load_scenario(scn8)
    wcfg8.run_time = 2.0
    NetController(wcfg8, port=47493, start_pad_s=1.0).run()
    dcfg8 = load_scenario(scn8)
    dcfg8.run_time = 16.0
    dctl8 = NetController(dcfg8, port=47494, start_pad_s=1.0)
    dctl8.run()
    dist8_factor = dctl8.steady_t / max(dctl8.steady_wall_time_s, 1e-9)
    node_margin8 = _node_margin(dctl8, dcfg8.run_time)

    # 48-process mode (the reference's cap, include/crts.hpp:189): one full
    # sim-second with 48 OS node processes through the TCP star.  The
    # AGGREGATE factor is bounded by the host's cores; the per-node CPU
    # margin is the host-count-independent real-time criterion.
    from cognitive_radio_network_tpu.runtime.config import (
        build_forty_eight_node_scenario,
    )

    cfg48, gains48 = build_forty_eight_node_scenario(run_time=1.0)
    cfg48.max_wall_time_s = 520.0
    ctl48 = NetController(cfg48, port=47497, start_pad_s=2.0)
    ctl48.medium.gains = gains48
    ctl48.run()
    # sim_time_s in node summaries is the STEADY WINDOW (last 3/4 of the
    # run); completion of the full 1.0 sim-s is the separate flag
    sim48 = max(
        (s.get("sim_time_s", 0.0) for s in ctl48.summaries.values()),
        default=0.0,
    )
    completed48 = (not ctl48.terminated) and len(ctl48.summaries) == 48
    dist48_factor = ctl48.steady_t / max(ctl48.steady_wall_time_s, 1e-9)
    node_margin48 = _node_margin(ctl48, cfg48.run_time)

    print(card_line(), flush=True)
    print(
        json.dumps(
            {
                "metric": "sense_classify_throughput_per_device",
                "value": msps,
                "unit": "MSamples/s",
                "vs_baseline": msps / TARGET_MSPS,
                "device": info,
                "extra": {
                    "card": card,
                    "jax": jax.__version__,
                    "trials": TRIALS,
                    "sense_msps_spread": [msps_lo, msps_hi],
                    "p50_block_latency_ms": p50_block_ms,
                    "p99_block_latency_ms": p99_block_ms,
                    "latency_method": "dispatch to block_until_ready, one block at a time, 400 samples",
                    "latency_block_cycles": lat_cycles,
                    "cycles_per_dispatch": cycles,
                    "reps": reps,
                    "bf16_ingest_msps": msps16,
                    "bf16_ingest_spread": [msps16_lo, msps16_hi],
                    "wideband_64ch_msps": wideband_msps,
                    "wideband_spread": [wideband_lo, wideband_hi],
                    "ofdm_link_msps": ofdm_msps,
                    "ofdm_link_spread": [ofdm_lo, ofdm_hi],
                    "ofdm_link_frames_per_s": ofdm_fps,
                    "adaptive_link_msps": adaptive_msps,
                    "adaptive_link_spread": [adaptive_lo, adaptive_hi],
                    "adaptive_link_frames_per_s": adaptive_fps,
                    "scenario_realtime_factor": realtime_factor,
                    "distributed_realtime_factor": dist_realtime_factor,
                    "distributed_realtime_factor_8node": dist8_factor,
                    "distributed_8node_max_node_cpu_per_sim_s": node_margin8,
                    "distributed_realtime_factor_48node": dist48_factor,
                    "distributed_48node_max_node_cpu_per_sim_s": node_margin48,
                    "distributed_48node_completed_sim_s": (
                        cfg48.run_time if completed48 else 0.0
                    ),
                    "distributed_48node_steady_sim_s": sim48,
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
