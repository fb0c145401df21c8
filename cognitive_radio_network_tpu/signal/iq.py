"""Canonical IQ representations.

The framework's on-device IQ formats are **float32 real pairs** in one of
two layouts:

* **planar** (preferred for the hot path): a ``(xr, xi)`` tuple of separate
  I and Q arrays, each ``(..., N)``.  I and Q live in distinct contiguous
  buffers, so kernels consume them with zero relayout cost.
* **interleaved planes**: one array ``(..., N, 2)`` with the last axis
  = [I, Q] (matches the de-facto interleaved SDR capture layout).
  De-interleaving on the device is an extra pass over the input — convert
  once on ingest (the native IQ loader de-interleaves on its CPU prefetch
  thread, native/src/iq_stream.cpp) or synthesize planar directly.

Rationale for real pairs at all: the matmul DFTs and the sense kernel work
on real arithmetic, so explicit planes feed them without a split, and they
unlock reduced-precision storage (bf16 IQ).

Complex arrays remain accepted at every public entry point for convenience
(tests, CPU analysis); ``split_iq`` normalizes any form to an (I, Q) pair.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["split_iq", "to_planes", "to_planar", "from_planes", "planes_abs2"]


def split_iq(x) -> tuple[jax.Array, jax.Array]:
    """Normalize complex (..., N), planes (..., N, 2), or a planar
    ``(xr, xi)`` tuple to (re, im), each (..., N)."""
    if isinstance(x, (tuple, list)):
        xr, xi = x
        return jnp.asarray(xr, jnp.float32), jnp.asarray(xi, jnp.float32)
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        # split on the host: the device gets float planes
        return (
            jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)),
        )
    if jnp.iscomplexobj(x):
        return jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
    if x.shape[-1] == 2:
        return x[..., 0].astype(jnp.float32), x[..., 1].astype(jnp.float32)
    raise ValueError(
        f"IQ input must be complex, (..., 2) planes, or an (xr, xi) tuple; "
        f"got {getattr(x, 'dtype', type(x))} {getattr(x, 'shape', '')}"
    )


def to_planar(x) -> tuple[jax.Array, jax.Array]:
    """Any IQ form -> planar (xr, xi) tuple (alias of split_iq)."""
    return split_iq(x)


def to_planes(x) -> jax.Array:
    """Complex array (host or device) -> float32 planes (..., 2)."""
    if isinstance(x, np.ndarray):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1).astype(jnp.float32)


def from_planes(x):
    """Planes (..., 2) -> complex64 (host numpy in, numpy out)."""
    if isinstance(x, np.ndarray):
        return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    return (x[..., 0] + 1j * x[..., 1]).astype(jnp.complex64)


def planes_abs2(x: jax.Array) -> jax.Array:
    """|z|^2 for planes input (..., N, 2) -> (..., N)."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
