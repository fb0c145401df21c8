"""The fused sense->classify pipeline (the framework's flagship model).

This is the accelerator re-design of the reference's entire per-node hot path —
``ECR_rx_worker``'s sample loop + ``CE_Predictive_Node::execute``'s
FFT/feature/MLP chain (src/extensible_cognitive_radio.cpp:1258-1382;
CE_Predictive_Node.cpp:127-289) — as ONE jitted batched graph:

    IQ stream (C cycles x A buffers x N samples, planar float32)
      -> batched DFT (real-split matmuls)      [fft.spectrum_magnitude]
      -> magnitude average over A buffers      [fft.averaged_magnitude_spectrum]
      -> band-energy features                  [bands.band_features]
      -> 4-5-3 sigmoid MLP                     [mlp.mlp_forward]
      -> occupancy decision + channel policy   [detector]

Decisions per cycle are data-independent; only the tx-frequency trace carries
cross-cycle state (the "else: keep sensing" branch), handled by a tiny
``lax.scan`` over scalar per-cycle decisions AFTER the heavy batched math, so
nothing serializes the batched math.

Cadence note: the reference senses 10 x 512-sample buffers every 100 ms and
idles in between. The framework processes the same math back-to-back over
arbitrarily many cycles per dispatch; the runtime layer (:mod:`..runtime`)
reintroduces the wall-clock cadence when emulating scenario timing.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from cognitive_radio_network_tpu.utils.platform import sense_fft_mode

from cognitive_radio_network_tpu.signal import bands as bands_mod
from cognitive_radio_network_tpu.signal import detector as det
from cognitive_radio_network_tpu.signal import fft as fft_mod
from cognitive_radio_network_tpu.signal.mlp import MLPParams

__all__ = ["SenseConfig", "sense_classify", "sense_classify_trace", "make_sense_fn"]


@dataclasses.dataclass(frozen=True)
class SenseConfig:
    """Static sensing parameters (CE_Predictive_Node.hpp:30-57)."""

    fft_length: int = 512
    averaging: int = 10
    threshold: float = 0.8
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS
    channels_hz: tuple[float, float, float] = det.SU_CHANNELS_HZ
    sample_rate_hz: float = 13e6
    center_hz: float = 833e6
    sensing_delay_ms: float = 100.0
    # spectrum math (signal/fft.spectrum_magnitude): "ct_matmul"
    # (Cooley-Tukey 4 x 128 factored DFT), "dft_matmul" (dense (N, N) DFT
    # matmul) or "xla" (jnp.fft; cuFFT on a GPU).  None = the platform's
    # choice, utils/platform.sense_fft_mode (GPU: cuFFT; CPU: ct_matmul).
    fft_mode: str | None = None
    # input transform applied to band features before the MLP: "none" (the
    # reference's raw squared-sums, matching its shipped weights) or
    # "log1p" (what models/train.py trains with; checkpoints record which)
    feature_transform: str = "none"
    # algorithm of the matmul DFT modes (signal/fft.matmul):
    # "highest" = f32 products (strict bit-match mode); "high" = bf16_3x
    # (~1e-5 relative error, default); "default" = one bf16 pass (~1e-2).
    # The "xla" mode computes in f32 whatever the name.
    precision: str = "high"

    @property
    def samples_per_cycle(self) -> int:
        return self.fft_length * self.averaging


def sense_classify(
    iq: jax.Array, params: MLPParams, cfg: SenseConfig = SenseConfig()
):
    """Batched sense->classify over C cycles.

    iq: planar tuple (xr, xi) each (C, A, N) or buffers-flat (C*A, N) —
    the preferred layout (see signal/iq.py) — or complex64 (C, A, N), or
    interleaved float32 planes (C, A, N, 2) / any flat shape reshapeable to
    them (planes cost a de-interleave pass). Returns dict of
    per-cycle arrays:
      avg_spectrum (C, N), features (C, 4), outputs (C, 3), decision (C,).
    """
    n, a = cfg.fft_length, cfg.averaging
    if isinstance(iq, (tuple, list)):
        blocks = tuple(jnp.asarray(v).reshape(-1, a, n) for v in iq)
    elif jnp.iscomplexobj(iq):
        blocks = iq.reshape(-1, a, n)
    else:
        blocks = iq.reshape(-1, a, n, 2)
    avg = fft_mod.averaged_magnitude_spectrum(
        blocks,
        averaging=a,
        mode=cfg.fft_mode or sense_fft_mode(n),
        precision=cfg.precision,
    )
    feats = bands_mod.band_features(avg, cfg.bands)
    from cognitive_radio_network_tpu.signal.mlp import mlp_forward

    mlp_in = jnp.log1p(feats) if cfg.feature_transform == "log1p" else feats
    outs = mlp_forward(params, mlp_in)
    decision = det.occupancy_decision(outs, cfg.threshold)
    return {
        "avg_spectrum": avg,
        "features": feats,
        "outputs": outs,
        "decision": decision,
    }


def sense_classify_trace(
    iq: jax.Array,
    params: MLPParams,
    initial_tx_freq_hz: jax.Array,
    cfg: SenseConfig = SenseConfig(),
):
    """sense_classify + the stateful tx-frequency trace.

    Returns (results dict, tx_freq trace (C,) float32): tx_freq[c] is the tx
    center frequency after cycle c's decision, with "all busy" keeping the
    previous frequency (CE_Predictive_Node.cpp:245-261).
    """
    res = sense_classify(iq, params, cfg)

    def step(freq, decision):
        new = det.next_tx_channel(decision, freq, cfg.channels_hz)
        return new, new

    _, trace = jax.lax.scan(
        step, jnp.asarray(initial_tx_freq_hz, jnp.float32), res["decision"]
    )
    return res, trace


@functools.lru_cache(maxsize=64)
def make_sense_fn(cfg: SenseConfig = SenseConfig(), *, with_trace: bool = False):
    """A jitted closure over the static config (donating the IQ buffer).

    Cached process-wide: every engine instance with the same config shares
    one compilation (N predictive nodes in one scenario must not compile N
    identical graphs)."""
    if with_trace:

        @jax.jit
        def fn(iq, params, tx0):
            return sense_classify_trace(iq, params, tx0, cfg)

        return fn

    @jax.jit
    def fn(iq, params):
        return sense_classify(iq, params, cfg)

    return fn
