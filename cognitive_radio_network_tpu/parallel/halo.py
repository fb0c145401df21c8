"""Overlap-save halo exchange over a mesh axis (ppermute ring pattern).

The sequence-parallel analog for streaming DSP (SURVEY.md §2.6, §5
"long-context"): each time shard processes a contiguous segment of the IQ
stream; the FIR filter needs the last ``halo`` phase rows of the *previous*
segment, which flow right-ward between ring neighbors via
``jax.lax.ppermute`` — the in-graph replacement for liquid-dsp's opaque
internal streaming state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from cognitive_radio_network_tpu.signal.channelizer import channelize_planes

__all__ = ["halo_exchange", "sharded_channelize"]


def halo_exchange(
    x: jax.Array, halo: int, axis_name: str, *, axis: int = 0
) -> jax.Array:
    """Prepend each shard's block with the previous shard's tail.

    x: per-shard array; ``axis`` is the (local) streaming dimension. Sends
    the trailing ``halo`` slices to the right ring neighbor; shard 0 receives
    zeros (stream start — an FIR starting from rest). Returns x extended by
    ``halo`` along ``axis``.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = jax.lax.slice_in_dim(x, x.shape[axis] - halo, x.shape[axis], axis=axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    from_left = jax.lax.ppermute(tail, axis_name, perm)
    from_left = jnp.where(idx == 0, jnp.zeros_like(from_left), from_left)
    return jnp.concatenate([from_left, x], axis=axis)


def sharded_channelize(
    planes: jax.Array,
    taps: jax.Array,
    mesh: Mesh,
    *,
    time_axis: str = "time",
    batch_axis: str | None = None,
    precision: str = "high",
) -> jax.Array:
    """Time-sharded polyphase channelizer with ppermute halo exchange.

    planes: (T*M, 2) wide stream, or (B, T*M, 2) batched. The stream axis is
    sharded over ``time_axis``; with ``batch_axis`` the leading dim is
    sharded too (data parallelism).  Returns (..., T, M, 2) channelized
    planes with the same sharding.
    """
    p, m = taps.shape
    halo = p - 1
    batched = planes.ndim == 3

    def local(planes_local, taps_):
        xp = planes_local.reshape(*planes_local.shape[:-2], -1, m, 2)
        t_dim = xp.ndim - 3  # the phase-row (time) axis
        xp_ext = halo_exchange(xp, halo, time_axis, axis=t_dim)
        hist = jax.lax.slice_in_dim(xp_ext, 0, halo, axis=t_dim)
        body = jax.lax.slice_in_dim(
            xp_ext, halo, xp_ext.shape[t_dim], axis=t_dim
        )
        flat = body.reshape(*body.shape[:t_dim], -1, 2)
        return channelize_planes(flat, taps_, history=hist, precision=precision)

    if batched:
        in_spec = P(batch_axis, time_axis)
        out_spec = P(batch_axis, time_axis)
    else:
        in_spec = P(time_axis)
        out_spec = P(time_axis)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(in_spec, P()),
        out_specs=out_spec,
        check_vma=False,
    )(planes, taps)
