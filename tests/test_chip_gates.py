"""On-device gates and the smoke script.

On the card:  python -m pytest -m gpu tests/test_chip_gates.py

The ``gpu``-marked tests run chip_smoke.py's phases at full size on the GPU
and skip elsewhere (the ``gpu_device`` fixture decides).  The unmarked
tests run the same phase functions at small sizes on the CPU, and check
that the smoke script and the benchmark refuse to run without a GPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.gpu
class TestOnDevice:
    def test_sense_matches_plain_graph(self, gpu_device):
        chip_smoke.phase_sense()

    def test_sense_matches_golden(self, gpu_device):
        chip_smoke.phase_golden()

    def test_bf16_ingest(self, gpu_device):
        chip_smoke.phase_bf16()

    def test_wideband_matches_numpy_oracle(self, gpu_device):
        chip_smoke.phase_wideband()

    def test_ofdm_block_decode_intact(self, gpu_device):
        chip_smoke.phase_ofdm()

    def test_adaptive_stream_decodes(self, gpu_device):
        chip_smoke.phase_adaptive()

    def test_scenario_nodes_survive(self, gpu_device):
        chip_smoke.phase_scenario()


class TestPhasesOnCPU:
    """The smoke script's phases at small sizes (CPU, plain XLA paths)."""

    def test_sense(self):
        res = chip_smoke.phase_sense(cycles=24, precisions=("highest", "high"))
        assert set(res) == {"highest", "high"}

    def test_golden(self):
        res = chip_smoke.phase_golden(cycles=16)
        assert all(r["decisions_equal"] == 16 for r in res.values())

    def test_bf16(self):
        assert chip_smoke.phase_bf16(cycles=8) < 2e-2

    def test_wideband(self):
        assert chip_smoke.phase_wideband(t_chan=2048, check_chan=1024) < 1e-4

    def test_ofdm(self):
        chip_smoke.phase_ofdm(frames=4)

    def test_adaptive(self):
        chip_smoke.phase_adaptive(frames=8)

    def test_four(self):
        res = chip_smoke.phase_four(t_chan=2048, batch=2, train_chan=1024)
        assert res["wideband_rel_err"] <= 1e-5

    def test_scenario(self):
        res = chip_smoke.phase_scenario(run_time=0.3)
        assert set(res) == {"host", "device"}


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, script],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
