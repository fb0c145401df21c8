"""Wideband sharded sense pipeline: 64-channel channelizer -> energy detect.

BASELINE.json config 5: "64-channel polyphase channelizer, channels +
time-blocks sharded across hosts with overlap-save halo exchange".  The
pipeline, as one pjit-ed graph over a ('time', 'channel'[, 'data']) mesh:

    wide IQ planes (T*M, 2), time-sharded
      -> sharded polyphase channelizer (ppermute halo)     [halo.py]
      -> per-channel per-cycle energy (reductions), resharded so the
         channel axis lies on the 'channel' mesh axis (XLA all_to_all)
      -> global noise-floor estimate across channels (psum via jnp.mean)
      -> per-channel occupancy decisions (energy detector), plus per-channel
         feature rows for the shared-weight MLP classifier

The cross-shard communication is exactly: the (P-1)-row FIR halo between
time neighbors (ppermute), one all-to-all at the time->channel reshard, and
one psum for the noise floor.  Every card reaches every other at the same
rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cognitive_radio_network_tpu.parallel.halo import sharded_channelize
from cognitive_radio_network_tpu.signal.channelizer import polyphase_taps
from cognitive_radio_network_tpu.signal.fft import matmul
from cognitive_radio_network_tpu.signal.iq import planes_abs2

__all__ = [
    "WidebandConfig",
    "wideband_sense",
    "wideband_energy_packed",
    "sharded_wideband_energy_packed",
    "make_wideband_fn",
]


@dataclasses.dataclass(frozen=True)
class WidebandConfig:
    num_channels: int = 64
    taps_per_channel: int = 8
    block_len: int = 128  # per-channel samples per sense cycle
    threshold_ratio: float = 4.0  # occupancy if energy > ratio * noise floor
    # matmul precision for the fused FIR+DFT channelizer: "highest" (f32),
    # "high" (bf16_3x, default), "default" (bf16 single pass, fastest)
    precision: str = "high"

    def taps(self) -> np.ndarray:
        return polyphase_taps(self.num_channels, self.taps_per_channel)


def wideband_sense(
    planes: jax.Array,
    taps: jax.Array,
    mesh: Mesh,
    cfg: WidebandConfig,
    *,
    batch_axis: str | None = None,
):
    """planes: (T*M, 2) / (B, T*M, 2) wide IQ at rate M * per-channel rate,
    or a planar tuple (xr, xi) of (T*M,) streams (the zero-relayout layout).

    Returns dict:
      energy   (..., C, M)  per-cycle per-channel mean power
      noise    (..., C, 1)  cross-channel noise-floor estimate
      occupied (..., C, M)  boolean energy-detector decisions
    with C = T / block_len sense cycles.

    The energy never needs the channelized IQ materialized, so both the
    unbatched time-sharded case and the batched (data-parallel) case route
    through the packed energy path (:func:`sharded_wideband_energy_packed`).
    Only inputs whose per-shard length doesn't divide into whole sense
    cycles fall back to the materializing channelizer.
    """
    m = cfg.num_channels
    has_channel = "channel" in mesh.axis_names
    t_axis = "time" if "time" in mesh.axis_names else None

    planar = isinstance(planes, (tuple, list))
    energy = None
    batched_arr = not planar and planes.ndim == 3 and batch_axis is not None
    if (planar or planes.ndim == 2) and batch_axis is None and t_axis:
        d = mesh.shape[t_axis]
        n_wide = planes[0].shape[0] if planar else planes.shape[0]
        t_total = n_wide // m
        if t_total % (d * cfg.block_len) == 0:
            xr, xi = planes if planar else (planes[..., 0], planes[..., 1])
            energy = sharded_wideband_energy_packed(
                xr, xi, mesh, cfg, time_axis=t_axis, precision=cfg.precision
            )
    elif batched_arr and t_axis:
        # data-parallel batch of streams: the same lane-packed energy
        # formulation, batch rows sharded over batch_axis, each row's
        # stream time-sharded with the per-row ppermute FIR halo — the
        # materializing channelizer (12x the FLOPs, channelized IQ in HBM)
        # is not on the training path
        dt = mesh.shape[t_axis]
        db = mesh.shape[batch_axis] if batch_axis in mesh.axis_names else 1
        b, n_wide = planes.shape[0], planes.shape[1]
        t_total = n_wide // m
        if b % db == 0 and t_total % (dt * cfg.block_len) == 0:
            energy = sharded_wideband_energy_packed(
                planes[..., 0],
                planes[..., 1],
                mesh,
                cfg,
                time_axis=t_axis,
                batch_axis=batch_axis,
                precision=cfg.precision,
            )

    if energy is None:
        chan = sharded_channelize(
            planes, taps, mesh, batch_axis=batch_axis, precision=cfg.precision
        )  # (..., T, M, 2)
        power = planes_abs2(chan)  # (..., T, M)
        cyc = power.reshape(*power.shape[:-2], -1, cfg.block_len, m)
        energy = jnp.mean(cyc, axis=-2)  # (..., C, M)

    if has_channel:
        spec = (
            P(batch_axis, t_axis, "channel")
            if batch_axis
            else P(t_axis, "channel")
        )
        energy = jax.lax.with_sharding_constraint(
            energy, NamedSharding(mesh, spec)
        )

    # Noise floor: mean of the quietest half of the channels (median-ish but
    # collective-friendly: one global sort-free estimate via mean/min mix).
    mean_e = jnp.mean(energy, axis=-1, keepdims=True)
    min_e = jnp.min(energy, axis=-1, keepdims=True)
    noise = 0.5 * (min_e + jnp.minimum(mean_e, 2.0 * min_e))
    occupied = energy > cfg.threshold_ratio * noise
    return {"energy": energy, "noise": noise, "occupied": occupied}


def _dft_complex_block(m: int) -> jax.Array:
    """(2M, 2M) real matrix computing the length-M DFT of lane-concat
    complex rows:  [yr | yi] = [vr | vi] @ [[Wre, Wim], [-Wim, Wre]].

    Constant-folded by XLA; with M=64 this is one dense 128x128 matrix —
    one matmul does the whole complex DFT."""
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    wre = np.cos(ang).astype(np.float32)
    wim = np.sin(ang).astype(np.float32)
    top = np.concatenate([wre, wim], axis=1)
    bot = np.concatenate([-wim, wre], axis=1)
    return jnp.asarray(np.concatenate([top, bot], axis=0))


def _fir_rows(
    v_in: jax.Array, taps: jax.Array, history: jax.Array | None
) -> jax.Array:
    """Depthwise polyphase FIR on lane-concat planes.

    v_in: (..., T, 2M) rows [xr_phases | xi_phases]; taps (P, M).  Returns
    (..., T, 2M) with v[t, c] = sum_p h[p, c] * v_in[t-p, c] per plane —
    eight shifted multiply-adds, no matmul.  ``history`` (..., P-1, 2M)
    seeds the first rows (overlap-save carry; zeros when None)."""
    p = taps.shape[0]
    ax = v_in.ndim - 2  # the phase-row (time) axis
    t = v_in.shape[ax]
    hf = jnp.flip(taps.astype(jnp.float32), axis=0)
    hf2 = jnp.concatenate([hf, hf], axis=1)  # (P, 2M): same taps per plane
    if history is None:
        history = jnp.zeros(
            (*v_in.shape[:ax], p - 1, v_in.shape[-1]), jnp.float32
        )
    ext = jnp.concatenate([history, v_in], axis=ax)  # (..., T+P-1, 2M)
    v = hf2[0] * jax.lax.slice_in_dim(ext, 0, t, axis=ax)
    for s in range(1, p):
        v = v + hf2[s] * jax.lax.slice_in_dim(ext, s, s + t, axis=ax)
    return v


def wideband_energy_packed(
    xr: jax.Array,
    xi: jax.Array,
    taps: jax.Array,
    cfg: WidebandConfig,
    *,
    precision: str = "high",
) -> jax.Array:
    """Single-chip fast path: planar wide stream -> per-cycle channel energy.

    Factored polyphase formulation on packed rows: the FIR is P shifted
    multiply-adds on (T, 2M) rows [vr | vi] (depthwise — the dense
    (P*M, M) G-matrix of signal/channelizer.py wastes ~PxM/(2M)=4x matmul
    FLOPs re-multiplying the window for every output), and the M-point DFT
    is ONE (T, 2M) @ (2M, 2M) complex-packed matmul (128x128 at M=64).
    ~14x fewer matmul FLOPs than the fused-G layout that this replaced;
    energy only (channelized IQ never materialized) — use
    sharded_channelize when per-channel streams are needed.

    xr/xi: (T*M,) float32.  Returns (C, M) with C = T / block_len.
    """
    m = cfg.num_channels
    t_total = xr.shape[0] // m
    if t_total % cfg.block_len:
        raise ValueError(f"T={t_total} must be a multiple of block_len")
    v_in = jnp.concatenate(
        [xr.reshape(t_total, m), xi.reshape(t_total, m)], axis=1
    )
    v = _fir_rows(v_in, taps, None)
    y = matmul(v, _dft_complex_block(m), precision)
    power = y[:, :m] ** 2 + y[:, m:] ** 2
    return power.reshape(t_total // cfg.block_len, cfg.block_len, m).mean(axis=1)


def sharded_wideband_energy_packed(
    xr: jax.Array,
    xi: jax.Array,
    mesh: Mesh,
    cfg: WidebandConfig,
    *,
    time_axis: str = "time",
    batch_axis: str | None = None,
    precision: str = "high",
) -> jax.Array:
    """Time-sharded lane-packed energy detector (BASELINE config 5 on the
    fast path): each shard runs :func:`wideband_energy_packed` on its
    segment, with the cross-shard FIR state — exactly ONE packed row
    (512 wide samples >= the P-1 phase-row history) — flowing between ring
    neighbors via the same ppermute halo as sharded_channelize.

    xr/xi: (T*M,) planar wide stream sharded over ``time_axis``, or
    (B, T*M) batched with the leading dim sharded over ``batch_axis`` —
    each batch row is an independent stream (its FIR starts from rest),
    and the halo exchange runs per row along the time axis.
    Returns (C, M) / (B, C, M) energies, sharded the same way.
    """
    from cognitive_radio_network_tpu.parallel.halo import halo_exchange
    m, p = cfg.num_channels, cfg.taps_per_channel
    taps = jnp.asarray(cfg.taps())
    dft = _dft_complex_block(m)
    batched = xr.ndim == 2

    def local(xr_l, xi_l):
        t_local = xr_l.shape[-1] // m
        lead = xr_l.shape[:-1]
        v_in = jnp.concatenate(
            [
                xr_l.reshape(*lead, t_local, m),
                xi_l.reshape(*lead, t_local, m),
            ],
            axis=-1,
        )
        # halo: previous shard's last P-1 phase rows seed this shard's FIR
        t_ax = v_in.ndim - 2
        ext = halo_exchange(v_in, p - 1, time_axis, axis=t_ax)
        hist = jax.lax.slice_in_dim(ext, 0, p - 1, axis=t_ax)
        v = _fir_rows(v_in, taps, history=hist)
        y = matmul(v, dft, precision)
        power = y[..., :m] ** 2 + y[..., m:] ** 2
        return power.reshape(
            *lead, t_local // cfg.block_len, cfg.block_len, m
        ).mean(axis=-2)

    from jax import shard_map

    spec = P(batch_axis, time_axis) if batched else P(time_axis)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
        check_vma=False,
    )(xr, xi)


def make_wideband_fn(mesh: Mesh, cfg: WidebandConfig, *, batch_axis: str | None = None):
    """Jitted wideband pipeline with input shardings bound to the mesh."""
    taps = jnp.asarray(cfg.taps())

    @functools.partial(jax.jit)
    def fn(planes):
        return wideband_sense(planes, taps, mesh, cfg, batch_axis=batch_axis)

    return fn
