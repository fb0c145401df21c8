"""CLI entry — the ``crts_controller`` equivalent.

    python -m cognitive_radio_network_tpu scenario scenarios/predictive_model.cfg
    python -m cognitive_radio_network_tpu master scenarios/scenario_master_template.cfg

Runs scenarios in-process against the simulated medium and writes structured
logs (npz + optional Octave export) under ``logs/``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_sense(args) -> int:
    """Stream a capture through sense->classify: the deployment hot path.

    Native prefetch thread de-interleaves to planar off the hot path
    (native/src/iq_stream.cpp); blocks batch into dispatches of
    cycles_per_dispatch sense cycles; decisions/features/tx-retune trace
    accumulate host-side. Falls back to the Python reader without the
    native library."""
    import time

    import numpy as np

    from cognitive_radio_network_tpu import native
    from cognitive_radio_network_tpu.io.iq import IQReader, StreamCursor
    from cognitive_radio_network_tpu.models import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu.signal.mlp import reference_weights

    cfg = SenseConfig()
    if args.weights:
        from cognitive_radio_network_tpu.io.checkpoint import load_mlp_with_meta

        params, meta = load_mlp_with_meta(args.weights)
        import dataclasses as _dc

        cfg = _dc.replace(cfg, feature_transform=meta["feature_transform"])
    else:
        params = reference_weights()
    fn = make_sense_fn(cfg)

    cursor = (
        StreamCursor.load(args.cursor)
        if args.cursor and Path(args.cursor).exists()
        else StreamCursor()
    )
    reader = IQReader(args.capture, cursor)
    block_samples = cfg.samples_per_cycle * args.cycles_per_dispatch

    decisions, features, freqs = [], [], []
    tx_freq = 833e6
    n_samples = 0
    t0 = None  # started after the first dispatch (excludes jit compile)
    timed_samples = 0
    if native.available():
        stream = native.NativeIQStream(
            args.capture, block_samples, start_sample=cursor.sample_index
        )
        blocks = stream.planar_blocks()
    else:
        stream = None
        blocks = (
            (b[..., 0].copy(), b[..., 1].copy())
            for b in reader.blocks(block_samples)
        )
    import jax.numpy as jnp

    for xr, xi in blocks:
        rows = args.cycles_per_dispatch * cfg.averaging
        out = fn(
            (
                jnp.asarray(xr.reshape(rows, cfg.fft_length)),
                jnp.asarray(xi.reshape(rows, cfg.fft_length)),
            ),
            params,
        )
        dec = np.asarray(out["decision"])
        decisions.append(dec)
        features.append(np.asarray(out["features"]))
        # retune policy host-side (next_tx_channel semantics,
        # CE_Predictive_Node.cpp:245-261): 1->ch2, 2->ch1, 3->ch2, 0->keep
        ch1, ch2, _ = cfg.channels_hz
        retune = {1: ch2, 2: ch1, 3: ch2}
        for d in dec:
            tx_freq = retune.get(int(d), tx_freq)
            freqs.append(tx_freq)
        n_samples += block_samples
        if t0 is None:
            t0 = time.perf_counter()
        else:
            timed_samples += block_samples
        if stream is not None:
            reader.cursor.sample_index = stream.cursor
    elapsed = (time.perf_counter() - t0) if t0 is not None else 0.0
    if stream is not None:
        stream.close()
    if args.cursor:
        reader.cursor.save(args.cursor)
    if not decisions:
        print("capture shorter than one dispatch; nothing sensed")
        return 1
    dec = np.concatenate(decisions)
    feats = np.concatenate(features)
    occ = np.bincount(dec, minlength=4)
    rate = timed_samples / elapsed / 1e6 if elapsed > 0 and timed_samples else 0.0
    print(
        f"sensed {n_samples/1e6:.1f} MSamples "
        f"({rate:.0f} MS/s steady-state, excl. compile) -> {len(dec)} cycles; "
        f"decisions: all-busy={occ[0]} ch1={occ[1]} ch2={occ[2]} ch3={occ[3]}; "
        f"final tx {freqs[-1]/1e6:.0f} MHz"
    )
    if args.out:
        np.savez_compressed(
            args.out,
            decision=dec,
            features=feats,
            tx_freq=np.asarray(freqs, np.float64),
            sample_rate_hz=reader.sample_rate_hz,
            center_hz=reader.center_hz,
        )
        print(f"saved {args.out}")
    return 0


def main(argv=None) -> int:
    from cognitive_radio_network_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()

    ap = argparse.ArgumentParser(prog="cognitive_radio_network_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("scenario", help="run one scenario file")
    sp.add_argument("path")
    sp.add_argument("-r", "--reps", type=int, default=1)
    sp.add_argument("-l", "--log-dir", default="logs")
    sp.add_argument("-t", "--run-time", type=float, default=None)
    sp.add_argument(
        "-d",
        "--distributed",
        action="store_true",
        help="run as a TCP controller with one OS process per node "
        "(the crts_controller star topology)",
    )
    sp.add_argument("-p", "--port", type=int, default=4444)
    sp.add_argument(
        "-m",
        "--manual",
        action="store_true",
        help="with -d: don't launch local node processes; wait for "
        "operators to start them (crts_controller -m)",
    )
    sp.add_argument(
        "--transport", choices=("auto", "native", "python"), default="auto"
    )
    sp.add_argument(
        "--launch",
        choices=("local", "manual", "ssh"),
        default=None,
        help="with -d: node launch mode — 'ssh' starts each node on its "
        "configured server_ip over ssh with sysout capture and exact-PID "
        "remote kill (crts_controller.cpp:404-421)",
    )
    sp.add_argument(
        "-a",
        "--addr",
        default="127.0.0.1",
        help="with --launch ssh: the controller address remote nodes dial",
    )

    np_ = sub.add_parser(
        "node",
        help="node client process (the crts_cognitive_radio / crts_interferer "
        "equivalent): connects to a controller and runs the node pushed to it",
    )
    np_.add_argument("-a", "--controller", required=True, help="controller host")
    np_.add_argument("-p", "--port", type=int, default=4444)
    np_.add_argument(
        "--transport", choices=("auto", "native", "python"), default="auto"
    )

    rh = sub.add_parser(
        "radio-host",
        help="third-party radio child process (the reference's "
        "execvp'd python radio, src/crts_cognitive_radio.cpp:660-720): "
        "loads a user radio file and serves the stdin/stdout step "
        "protocol for a parent node (runtime/procradio.py)",
    )
    rh.add_argument("python_file")
    rh.add_argument("--node-id", type=int, required=True)
    rh.add_argument("--medium-rate", type=float, required=True)
    rh.add_argument("--medium-center", type=float, required=True)
    rh.add_argument("--config-json", required=True)

    mp = sub.add_parser("master", help="run a master scenario list")
    mp.add_argument("path")
    mp.add_argument("-l", "--log-dir", default="logs")

    ep = sub.add_parser("engines", help="list registered engines/controllers")

    tp = sub.add_parser(
        "train", help="train the occupancy classifier on synthetic scenes"
    )
    tp.add_argument("-n", "--num-examples", type=int, default=400)
    tp.add_argument("-s", "--steps", type=int, default=2000)
    tp.add_argument("--lr", type=float, default=3e-3)
    tp.add_argument("-o", "--out", default="checkpoints/occupancy_mlp.npz")
    tp.add_argument("--seed", type=int, default=0)

    sn = sub.add_parser(
        "sense",
        help="stream a recorded IQ capture through the fused sense->classify "
        "pipeline (native prefetcher -> planar ingest -> device)",
    )
    sn.add_argument("capture", help="raw interleaved f32 I/Q file (io.IQWriter)")
    sn.add_argument("-o", "--out", default=None, help="save results .npz")
    sn.add_argument("-c", "--cycles-per-dispatch", type=int, default=256)
    sn.add_argument("--cursor", default=None, help="resume cursor file")
    sn.add_argument(
        "-w", "--weights", default=None, help="trained MLP checkpoint (npz)"
    )

    wp = sub.add_parser("spectrum", help="headless spectrum analyzer")
    wp.add_argument("spectrum_args", nargs=argparse.REMAINDER)

    xp = sub.add_parser(
        "export", help="convert saved run logs (.npz, or a .crnl binary "
        "log / directory of them) to Octave .m (the "
        "convert_logs_bin_to_octave equivalent)"
    )
    xp.add_argument("path")
    xp.add_argument("-o", "--out", required=True)

    args = ap.parse_args(argv)

    from cognitive_radio_network_tpu.runtime import (
        MasterConfig,
        controller_names,
        engine_names,
        load_master,
        load_scenario,
        run_master,
    )

    if args.cmd == "node":
        from cognitive_radio_network_tpu.runtime.netctl import run_node_client

        return run_node_client(args.controller, args.port, args.transport)

    if args.cmd == "radio-host":
        from cognitive_radio_network_tpu.runtime.procradio import run_radio_host

        return run_radio_host(
            args.python_file,
            args.node_id,
            args.medium_rate,
            args.medium_center,
            args.config_json,
        )

    if args.cmd == "engines":
        print("cognitive engines:", ", ".join(engine_names()))
        print("scenario controllers:", ", ".join(controller_names()))
        return 0

    if args.cmd == "sense":
        return _cmd_sense(args)

    if args.cmd == "spectrum":
        from cognitive_radio_network_tpu.tools.spectrum_analyzer import main as smain

        return smain(args.spectrum_args)

    if args.cmd == "export":
        import numpy as np

        src = Path(args.path)
        columns: dict[str, "np.ndarray"] = {}
        if src.is_dir() or src.suffix == ".crnl":
            from cognitive_radio_network_tpu.runtime.logging import (
                read_binlog,
                read_binlog_dir,
            )

            streams = (
                read_binlog_dir(src)
                if src.is_dir()
                else dict([read_binlog(src)])
            )
            for stream, recs in streams.items():
                if not recs:
                    continue
                for k in recs[0]:
                    columns[f"{stream}_{k}"] = np.array([r[k] for r in recs])
        else:
            data = np.load(src, allow_pickle=True)
            for key in data.files:
                columns[key.replace(".", "_")] = data[key]
        lines = []
        for var, v in columns.items():
            if v.dtype.kind in "OU":
                lines.append(f"{var} = {{{', '.join(repr(str(x)) for x in v)}}};")
            else:
                vals = ", ".join(str(x) for x in np.asarray(v, float))
                lines.append(f"{var} = [{vals}];")
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
        print(f"wrote {len(lines)} variables to {args.out}")
        return 0

    if args.cmd == "train":
        import jax
        import numpy as np

        from cognitive_radio_network_tpu.io.checkpoint import save_mlp
        from cognitive_radio_network_tpu.models.train import (
            TrainConfig,
            fit,
            make_dataset,
        )
        from cognitive_radio_network_tpu.signal.mlp import mlp_forward
        import jax.numpy as jnp

        key = jax.random.key(args.seed)
        feats, labels = make_dataset(key, args.num_examples)
        tcfg = TrainConfig(learning_rate=args.lr, num_steps=args.steps)
        params, losses = fit(jax.random.key(args.seed + 1), feats, labels, tcfg)
        preds = mlp_forward(params, jnp.log1p(feats)) > 0.5
        acc = float(jnp.mean(preds == (labels > 0.5)))
        save_mlp(args.out, params, feature_transform="log1p" if tcfg.log_features else "none")
        print(
            f"trained {args.num_examples} examples, {args.steps} steps: "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, accuracy {acc:.3f}; "
            f"saved {args.out}"
        )
        return 0

    if args.cmd == "scenario":
        cfg = load_scenario(args.path)
        if args.run_time is not None:
            cfg.run_time = args.run_time
        if args.distributed:
            from cognitive_radio_network_tpu.runtime.netctl import NetController

            summaries = []
            for rep in range(1, args.reps + 1):
                rep_cfg = load_scenario(args.path)
                if args.run_time is not None:
                    rep_cfg.run_time = args.run_time
                ctl = NetController(
                    rep_cfg,
                    port=args.port,
                    transport=args.transport,
                    launch=args.launch
                    or ("manual" if args.manual else "local"),
                    controller_addr=args.addr,
                )
                summaries.append(ctl.run(rep))
        else:
            master = MasterConfig(
                scenarios=[(cfg.name, args.reps)], octave_log_summary=True
            )

            def _load(name):
                c = load_scenario(args.path)
                if args.run_time is not None:
                    c.run_time = args.run_time
                return c

            summaries = run_master(master, _load, args.log_dir)
    else:
        master = load_master(args.path)
        base = Path(args.path).parent
        summaries = run_master(
            master, lambda name: load_scenario(base / f"{name}.cfg"), args.log_dir
        )

    for s in summaries:
        print(
            f"{s.scenario} rep {s.rep}: bytes_sent={s.bytes_sent} "
            f"bytes_received={s.bytes_received} valid_frames={s.valid_frames}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
