"""Dynamic window extraction for frame-aligned slices.

The OFDM rx graphs need rows ``x[off_k : off_k + wlen]`` at K dynamic
offsets (frame starts found by detection).  Each row is contiguous, and a
vmapped ``lax.dynamic_slice`` lowers to one gather of contiguous rows,
which XLA:GPU turns into coalesced loads.

Replaces the per-sample streaming buffer walk of liquid's
ofdmflexframesync_execute (src/extensible_cognitive_radio.cpp:1307): the
reference touches every sample once per frame search; here detection reads
the stream once and decode reads exactly the frame windows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["extract_windows"]


def extract_windows(rr, ri, offsets, wlen: int):
    """rr/ri (N,) f32 + offsets (K,) int -> ((K, wlen), (K, wlen)) with row k
    = plane[offset_k : offset_k + wlen] (offsets clipped to [0, N - wlen])."""
    n = rr.shape[0]

    def one(o):
        o = jnp.clip(o, 0, max(n - wlen, 0))
        return (
            jax.lax.dynamic_slice(rr, (o,), (wlen,)),
            jax.lax.dynamic_slice(ri, (o,), (wlen,)),
        )

    if n < wlen:
        rr = jnp.pad(rr, (0, wlen - n))
        ri = jnp.pad(ri, (0, wlen - n))
    return jax.vmap(one)(offsets.astype(jnp.int32))
