"""Multi-process networked scenario runtime (runtime/netctl.py).

Covers: wire-format interop between the native C++ transport and the pure-
Python transport; the full controller <-> node-process protocol
(SCENARIO_PARAMETERS -> START -> lockstep TX/RX blocks -> CONTROL/FEEDBACK
-> TERMINATE -> SUMMARY) with real OS subprocesses; and equivalence of the
distributed run against the in-process ScenarioRuntime on the same scenario
(the medium is seeded, steps are lockstep, so traffic accounting matches).
"""

import json
import os
import threading

import numpy as np
import pytest

from cognitive_radio_network_tpu import native
from cognitive_radio_network_tpu.runtime import (
    NodeConfig,
    ScenarioConfig,
    ScenarioRuntime,
)
from cognitive_radio_network_tpu.runtime.netctl import (
    Msg,
    NetController,
    PyMsgTransport,
    _pack_block,
    _unpack_block,
)


def _two_node_scenario(run_time=0.1):
    """Two OFDM radios on an FDD link over the medium (the known-good link
    shape from test_runtime.py), small enough for subprocess tests."""
    common = dict(
        cognitive_engine="CE_Template",
        ce_timeout_ms=1000.0,
        net_mean_throughput=200e3,
        tx_rate=1e6,
        rx_rate=1e6,
        tx_gain=20.0,
        rx_gain=20.0,
        tx_gain_soft=-6.0,
    )
    return ScenarioConfig(
        num_nodes=2,
        run_time=run_time,
        nodes=[
            NodeConfig(tx_freq=464e6, rx_freq=466e6, **common),
            NodeConfig(tx_freq=466e6, rx_freq=464e6, **common),
        ],
        medium_rate=4e6,
        medium_center=465e6,
        medium_block_len=16384,
        medium_noise_power=1e-7,
        seed=3,
        name="netctl_test",
    )


class TestBlockPacking:
    def test_roundtrip(self, rng):
        block = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        step, out = _unpack_block(_pack_block(7, block))
        assert step == 7
        np.testing.assert_array_equal(out, block)

    def test_none_block(self):
        step, out = _unpack_block(_pack_block(3, None))
        assert step == 3 and out is None


class TestTransportInterop:
    """Native C++ endpoint on one side, pure-Python on the other —
    same wire format."""

    @pytest.mark.skipif(not native.available(), reason="native lib unavailable")
    def test_python_client_native_server(self):
        srv = native.MsgTransport.listen(47201)
        got = {}

        def server():
            conn = native.MsgTransport.accept(srv, 5000)
            got["msg"] = conn.recv(5000)
            conn.send(Msg.CONTROL, json.dumps({"param": 1, "value": 2.5}).encode())
            conn.close()

        t = threading.Thread(target=server)
        t.start()
        cli = PyMsgTransport.connect("127.0.0.1", 47201, 5000)
        cli.send(Msg.FEEDBACK, b'{"node": 0}')
        typ, payload = cli.recv(5000)
        t.join(10)
        assert got["msg"] == (Msg.FEEDBACK, b'{"node": 0}')
        assert typ == Msg.CONTROL and json.loads(payload)["value"] == 2.5
        cli.close()
        native.MsgTransport.close_server(srv)

    @pytest.mark.skipif(not native.available(), reason="native lib unavailable")
    def test_native_client_python_server(self):
        srv = PyMsgTransport.listen(47202)
        got = {}

        def server():
            conn = PyMsgTransport.accept(srv, 5000)
            got["msg"] = conn.recv(5000)
            conn.send(9, b"\x00\x01\x02")
            conn.close()

        t = threading.Thread(target=server)
        t.start()
        cli = native.MsgTransport.connect("127.0.0.1", 47202, 5000)
        cli.send(Msg.TX_BLOCK, _pack_block(0, None))
        typ, payload = cli.recv(5000)
        t.join(10)
        assert got["msg"] == (Msg.TX_BLOCK, _pack_block(0, None))
        assert (typ, payload) == (9, b"\x00\x01\x02")
        cli.close()
        PyMsgTransport.close_server(srv)

    @pytest.mark.parametrize("side", ["python", "native"])
    def test_send2_scatter_gather_matches_pack(self, side, rng):
        """send2 (zero-copy scatter-gather of a numpy block) produces the
        exact bytes _pack_block would — both transports, large payload so
        the native writev path and the Python sendmsg path both engage."""
        if side == "native" and not native.available():
            pytest.skip("native lib unavailable")
        tcls = native.MsgTransport if side == "native" else PyMsgTransport
        port = 47204 if side == "python" else 47205
        srv = PyMsgTransport.listen(port)
        got = {}

        def server():
            conn = PyMsgTransport.accept(srv, 5000)
            got["msg"] = conn.recv(5000)
            conn.close()

        t = threading.Thread(target=server)
        t.start()
        cli = tcls.connect("127.0.0.1", port, 5000)
        block = (
            rng.standard_normal(65536) + 1j * rng.standard_normal(65536)
        ).astype(np.complex64)
        import struct as _struct

        cli.send2(Msg.TX_BLOCK, _struct.pack("<I", 11), block)
        t.join(10)
        typ, payload = got["msg"]
        assert typ == Msg.TX_BLOCK
        assert payload == _pack_block(11, block)
        step, out = _unpack_block(payload)
        assert step == 11
        np.testing.assert_array_equal(out, block)
        cli.close()
        PyMsgTransport.close_server(srv)

    def test_python_python_roundtrip(self):
        srv = PyMsgTransport.listen(47203)
        got = {}

        def server():
            conn = PyMsgTransport.accept(srv, 5000)
            got["a"] = conn.recv(5000)
            got["none"] = conn.recv(50)  # timeout -> None
            conn.close()

        t = threading.Thread(target=server)
        t.start()
        cli = PyMsgTransport.connect("127.0.0.1", 47203, 5000)
        cli.send(Msg.START, b"{}")
        t.join(10)
        assert got["a"] == (Msg.START, b"{}")
        assert got["none"] is None
        cli.close()
        PyMsgTransport.close_server(srv)


@pytest.mark.slow
class TestDistributedScenario:
    """Full star-topology run with real node subprocesses."""

    def _run(self, transport, port):
        cfg = _two_node_scenario()
        ctl = NetController(cfg, port=port, transport=transport, start_pad_s=0.1)
        return ctl.run(), ctl

    def test_distributed_run_matches_inprocess(self):
        cfg = _two_node_scenario()
        inproc = ScenarioRuntime(cfg).run()
        dist, ctl = self._run("python", 47310)
        # same seeded medium + lockstep stepping -> identical traffic totals
        assert dist.bytes_sent == inproc.bytes_sent
        assert dist.frames_received == inproc.frames_received
        assert dist.valid_frames == inproc.valid_frames
        assert sum(dist.valid_frames) > 0, "no frames crossed the medium"

    def test_serial_mode_matches_inprocess(self):
        """net_pipeline=false restores the strictly serial lockstep loop —
        still bit-identical to the in-process runtime (the pipelined
        default is covered by test_distributed_run_matches_inprocess)."""
        cfg = _two_node_scenario()
        cfg.net_pipeline = False
        inproc = ScenarioRuntime(cfg).run()
        ctl = NetController(cfg, port=47316, transport="python", start_pad_s=0.1)
        dist = ctl.run()
        assert dist.bytes_sent == inproc.bytes_sent
        assert dist.frames_received == inproc.frames_received
        assert dist.valid_frames == inproc.valid_frames
        assert sum(dist.valid_frames) > 0, "no frames crossed the medium"

    @pytest.mark.skipif(not native.available(), reason="native lib unavailable")
    def test_distributed_run_native_transport(self):
        dist, ctl = self._run("native", 47311)
        assert sum(dist.valid_frames) > 0
        assert all(b > 0 for b in dist.bytes_sent)

    def test_sc_control_reaches_nodes(self):
        """An SC that retunes node 0 mid-run over CRTS_MSG_CONTROL and
        enables feedback; the controller must receive TX_FREQ feedback."""
        from cognitive_radio_network_tpu.runtime.engine import register_controller
        from cognitive_radio_network_tpu.runtime.scenario import (
            CrtsParam,
            ScenarioController,
        )

        feedback_log = []

        @register_controller("SC_NetctlTest")
        class SC_NetctlTest(ScenarioController):
            def initialize_node_fb(self):
                # enable TX_FREQ feedback on node 0
                self.set_node_parameter(0, CrtsParam.FB_EN, 1 << CrtsParam.TX_FREQ.value)
                self._retuned = False

            def execute(self):
                if self.fb is not None:
                    feedback_log.append((self.fb.node, self.fb.param, self.fb.value))
                if not self._retuned:
                    self._retuned = True
                    self.set_node_parameter(0, CrtsParam.TX_FREQ, 837e6)

        cfg = _two_node_scenario(run_time=0.05)
        cfg.scenario_controller = "SC_NetctlTest"
        cfg.sc_timeout_ms = 0.1
        ctl = NetController(cfg, port=47312, transport="python", start_pad_s=0.1)
        ctl.run()
        tx_freq_fbs = [
            v for (n, p, v) in feedback_log if n == 0 and p is CrtsParam.TX_FREQ
        ]
        assert 837e6 in tx_freq_fbs, f"feedback log: {feedback_log}"


@pytest.mark.slow
class TestDistributedEdgeCases:
    def test_interferer_node_in_distributed_mode(self):
        """A CW interferer node runs as its own OS process; the radio node
        receives its energy through the controller-hosted medium."""
        radio = NodeConfig(
            cognitive_engine="CE_Template",
            net_mean_throughput=200e3,
            tx_freq=464e6,
            tx_rate=1e6,
            rx_freq=465e6,
            rx_rate=1e6,
        )
        interferer = NodeConfig(
            node_type="interferer",
            interference_type="cw",
            tx_freq=465e6,
            tx_rate=1e6,
            tx_gain=25.0,
            duty_cycle=1.0,
        )
        cfg = ScenarioConfig(
            num_nodes=2,
            run_time=0.02,
            nodes=[radio, interferer],
            medium_rate=4e6,
            medium_center=465e6,
            medium_block_len=16384,
            medium_noise_power=1e-9,
            name="netctl_interferer",
        )
        ctl = NetController(cfg, port=47320, transport="python", start_pad_s=0.1)
        summary = ctl.run()
        # interferer contributes no traffic counters but the run completes
        assert summary.bytes_sent[1] == 0
        assert summary.bytes_sent[0] > 0

    def test_node_crash_surfaces_stderr(self, tmp_path):
        """A node process that dies mid-run is detected; the controller's
        error carries the remote traceback (the reference just noticed the
        disconnect, src/crts_controller.cpp:43-54)."""
        # a crashing engine would need registration inside the node process;
        # instead point a python-radio node at a file that raises
        bad = tmp_path / "bad_radio.py"
        bad.write_text(
            "def create_node(node_id, medium_rate, medium_center, config):\n"
            "    raise RuntimeError('deliberate-crash-for-test')\n"
        )
        a = NodeConfig(
            cognitive_radio_type="python",
            python_file=str(bad),
            tx_freq=464e6,
            rx_freq=466e6,
        )
        b = NodeConfig(cognitive_engine="CE_Template", tx_freq=466e6, rx_freq=464e6)
        cfg = ScenarioConfig(
            num_nodes=2,
            run_time=0.02,
            nodes=[a, b],
            medium_rate=4e6,
            medium_block_len=16384,
            name="netctl_crash",
        )
        ctl = NetController(cfg, port=47321, transport="python", start_pad_s=0.1)
        with pytest.raises((ConnectionError, TimeoutError)) as ei:
            ctl.run()
        assert "deliberate-crash-for-test" in str(ei.value)


def _eight_node_scenario(run_time=0.06):
    """The 8-node mixed scenario of test_scenarios.py (3 FDD pairs + 2
    interferers, 16 MHz medium) — the reference-scale multi-process
    workload (include/crts.hpp:189 allows 48 node processes)."""
    common = dict(
        cognitive_engine="CE_Template",
        ce_timeout_ms=1000.0,
        net_mean_throughput=200e3,
        tx_rate=1e6,
        rx_rate=1e6,
        tx_gain=20.0,
        rx_gain=20.0,
        tx_gain_soft=-6.0,
    )
    nodes = []
    for base in (461e6, 465e6, 469e6):
        nodes.append(NodeConfig(tx_freq=base, rx_freq=base + 2e6, **common))
        nodes.append(NodeConfig(tx_freq=base + 2e6, rx_freq=base, **common))
    nodes.append(
        NodeConfig(
            node_type="interferer",
            interference_type="cw",
            tx_freq=473e6,
            tx_gain=15.0,
            duty_cycle=0.5,
            period=0.01,
        )
    )
    nodes.append(
        NodeConfig(
            node_type="interferer",
            interference_type="noise",
            tx_freq=459e6,
            tx_gain=10.0,
            tx_freq_behavior="sweep",
            tx_freq_min=458e6,
            tx_freq_max=460e6,
            tx_freq_dwell_time=0.005,
            tx_freq_resolution=0.5e6,
        )
    )
    return ScenarioConfig(
        num_nodes=8,
        run_time=run_time,
        nodes=nodes,
        medium_rate=16e6,
        medium_center=466e6,
        medium_block_len=65536,
        medium_noise_power=1e-8,
        name="eight_node_dist",
    )


@pytest.mark.slow
class TestManyProcessScenario:
    """Reference-scale node-process counts over the TCP star
    (src/crts_controller.cpp:341-421 launches one process per node)."""

    def test_eight_node_distributed_matches_inprocess(self):
        """8 OS node processes; traffic accounting must match the
        in-process runtime on the same seeded lockstep medium."""
        inproc = ScenarioRuntime(_eight_node_scenario()).run()
        ctl = NetController(
            _eight_node_scenario(), port=47330, transport="auto", start_pad_s=0.1
        )
        dist = ctl.run()
        assert dist.bytes_sent == inproc.bytes_sent
        assert dist.frames_received == inproc.frames_received
        assert dist.valid_frames == inproc.valid_frames
        for i in range(6):
            assert dist.bytes_sent[i] > 0
        assert sum(dist.valid_frames) > 0

    def test_forty_eight_process_smoke(self):
        """The reference's 48-node cap as REAL OS processes
        (include/crts.hpp:189): 8 cells x (2 FDD pairs + 2 interferers),
        cross-cell gain 0 (config.build_forty_eight_node_scenario — the
        same scenario bench.py runs for a FULL sim-second; here a
        wall-guarded smoke: the run completes, every radio transmits, and
        summaries arrive from all 48 processes)."""
        from cognitive_radio_network_tpu.runtime.config import (
            build_forty_eight_node_scenario,
        )

        cfg, gains = build_forty_eight_node_scenario(run_time=0.02)
        per_cell = 6
        ctl = NetController(cfg, port=47331, transport="auto", start_pad_s=0.1)
        ctl.medium.gains = gains
        summary = ctl.run()
        assert not ctl.terminated, "hit the wall-clock guard"
        assert len(ctl.summaries) == 48, sorted(ctl.summaries)
        radios = [i for i in range(48) if i % per_cell < 4]
        for i in radios:
            assert summary.bytes_sent[i] > 0, f"node {i} sent nothing"


@pytest.mark.slow
class TestSshLaunch:
    """launch='ssh': automated remote-host node launch with sysout capture
    and exact-PID remote kill (src/crts_controller.cpp:404-421, :567-577).
    No sshd in CI, so the ssh argv prefix is stubbed with a shell that
    drops the host argument and runs the remote command locally — the
    full ssh code path (argv build, PID handshake, sysout capture, remote
    kill) is exercised end to end."""

    @staticmethod
    def _stub_ssh(tmp_path):
        stub = tmp_path / "fake_ssh"
        stub.write_text('#!/bin/sh\n# $1 = user@host, $2 = remote command\nexec sh -c "$2"\n')
        stub.chmod(0o755)
        return stub

    def test_ssh_launch_end_to_end(self, tmp_path):
        import sys as _sys

        cfg = _two_node_scenario()
        for nc in cfg.nodes:
            nc.server_ip = "127.0.0.1"
            nc.server_user = "tester"
        ctl = NetController(
            cfg,
            port=47340,
            transport="python",
            launch="ssh",
            start_pad_s=0.1,
            ssh_cmd=[str(self._stub_ssh(tmp_path))],
            remote_python=_sys.executable,
            sysout_dir=str(tmp_path / "sysout"),
        )
        summary = ctl.run()
        assert sum(summary.valid_frames) > 0
        # sysout captured per node, with the PID handshake line
        for i in range(2):
            log = tmp_path / "sysout" / f"{cfg.name}_node{i}.log"
            assert log.exists(), log
            assert ctl._remote_pid(i) is not None
        # ssh targets carry the configured login
        assert ctl._ssh_hosts == ["tester@127.0.0.1"] * 2

    def test_ssh_launch_env_isolated(self, tmp_path):
        """Round-4 review item: the plain stub inherits this process's
        environment and cwd, so it cannot prove the remote command line
        stands alone.  This stub mimics a real ssh login: `env -i` wipes
        the environment (fresh HOME, minimal PATH, no JAX/XLA vars, no
        inherited cwd) before running the remote command — the launch,
        PID handshake, sysout capture, and scenario must still work from
        nothing but the command line the controller builds
        (src/crts_controller.cpp:404-421)."""
        import sys as _sys
        from pathlib import Path as _P

        repo = _P(__file__).resolve().parent.parent
        remote_home = tmp_path / "remote_home"
        remote_home.mkdir()
        stub = tmp_path / "fake_ssh_isolated"
        stub.write_text(
            "#!/bin/sh\n"
            "# $1 = user@host, $2 = remote command — run it like a fresh\n"
            "# ssh login: clean env, remote HOME as cwd\n"
            f"cd {remote_home} || exit 1\n"
            'echo "CRN_REMOTE_CWD $(pwd)"\n'
            'echo "CRN_REMOTE_ENVCOUNT $(env -i env | wc -l)"\n'
            f"exec env -i HOME={remote_home} PATH=/usr/bin:/bin "
            f"PYTHONPATH={repo} "
            'sh -c "$2"\n'
        )
        stub.chmod(0o755)
        cfg = _two_node_scenario()
        for nc in cfg.nodes:
            nc.server_ip = "127.0.0.1"
            nc.server_user = "remoteuser"
        ctl = NetController(
            cfg,
            port=47343,
            transport="python",
            launch="ssh",
            start_pad_s=0.1,
            ssh_cmd=[str(stub)],
            remote_python=_sys.executable,
            sysout_dir=str(tmp_path / "sysout"),
        )
        summary = ctl.run()
        assert sum(summary.valid_frames) > 0
        for i in range(2):
            log = tmp_path / "sysout" / f"{cfg.name}_node{i}.log"
            text = log.read_text()
            # the "remote" side really ran cwd-isolated...
            assert f"CRN_REMOTE_CWD {remote_home}" in text, text[:400]
            # ...and the PID handshake still parsed from the captured log
            assert ctl._remote_pid(i) is not None
        assert ctl._ssh_hosts == ["remoteuser@127.0.0.1"] * 2

    def test_ssh_forceful_kill_exact_pid(self, tmp_path):
        """A node that never connects (stub sleeps) is remote-killed by
        its exact PID on cleanup rather than leaking."""
        import sys as _sys

        import sys as _sys

        cfg = _two_node_scenario(run_time=0.02)
        ctl = NetController(
            cfg,
            port=47341,
            transport="python",
            launch="ssh",
            start_pad_s=0.1,
            accept_timeout_s=6.0,
            ssh_cmd=[str(self._stub_ssh(tmp_path))],
            # a "node" that prints its PID then hangs WITHOUT connecting
            # (exec keeps the echoed PID), so only the remote exact-PID
            # kill can reap it
            remote_python=(
                f"{_sys.executable} -c 'import time; time.sleep(600)' #"
            ),
            sysout_dir=str(tmp_path / "sysout"),
        )
        with pytest.raises(TimeoutError):
            ctl.run()
        # cleanup ran _ssh_kill on the parsed PIDs; the sleeps must be gone
        import os, signal, time as _time

        for i in range(2):
            pid = ctl._remote_pid(i)
            assert pid is not None
            deadline = _time.time() + 10
            alive = True
            while _time.time() < deadline:
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    alive = False
                    break
                _time.sleep(0.2)
            assert not alive, f"remote pid {pid} leaked"


@pytest.mark.slow
class TestPipelinedProduceAccounting:
    def test_sample_cursors_advance_exactly_once_per_step(self):
        """Round-4 review regression: the pipelined loop's speculative
        produce() returning None (a silent block) must NOT be re-run —
        that double-advanced tx sample cursors on every silent block
        (interferer duty/dwell timelines ran 2x; mixer phase jumped).
        Every node's cursor must equal exactly num_steps * block_len."""
        import math

        cfg = _two_node_scenario(run_time=0.1)
        # add a duty-cycled interferer: its pull_tx_block returns None for
        # the OFF half of every period — the trigger for the bug
        cfg.nodes.append(
            NodeConfig(
                node_type="interferer",
                interference_type="cw",
                tx_freq=465e6,
                duty_cycle=0.3,
                period=0.02,
            )
        )
        cfg.num_nodes = 3
        assert cfg.net_pipeline  # the default, and the mode under test
        ctl = NetController(cfg, port=47345, transport="python", start_pad_s=0.1)
        ctl.run()
        num_steps = math.ceil(cfg.run_time / (cfg.medium_block_len / cfg.medium_rate))
        expect = num_steps * cfg.medium_block_len
        for i in range(3):
            assert ctl.summaries[i]["tx_samples"] == expect, (
                i,
                ctl.summaries[i]["tx_samples"],
                expect,
            )


@pytest.mark.parametrize("placement", ["host", "device"])
def test_node_processes_and_the_device(monkeypatch, placement):
    """One process per card: host-placed node processes launch with
    JAX_PLATFORMS=cpu; device-placed ones refuse to start unless each has
    a share of device memory, and then keep the default platform."""
    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    cfg = _two_node_scenario()
    cfg.phy_placement = placement
    if placement == "device":
        with pytest.raises(ValueError, match="XLA_PYTHON_CLIENT_MEM_FRACTION"):
            NetController(cfg, port=0)
        monkeypatch.setenv("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.3")
    env = NetController(cfg, port=0)._node_env()
    if placement == "host":
        assert env["JAX_PLATFORMS"] == "cpu"
    else:
        assert env["XLA_PYTHON_CLIENT_MEM_FRACTION"] == "0.3"
        assert env.get("JAX_PLATFORMS") == os.environ.get("JAX_PLATFORMS")
