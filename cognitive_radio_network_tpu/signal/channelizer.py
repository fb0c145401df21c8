"""Critically-sampled polyphase analysis channelizer.

The wideband scale-out primitive (BASELINE.json config 5): splits one wide IQ
stream into M equal channels via an M-phase FIR filterbank + length-M IDFT.
There is no equivalent in the reference (its 3 channels are sensed jointly in
one 512-pt FFT); this is the new-design component that makes 64-channel
wideband sensing shardable.

Math (standard PFB analysis, commutator form):
    xp[t, c] = x[t*M + c]                       (phase decomposition)
    v[t, c]  = sum_p h[p, c] * xp[t-p, c]       (per-phase FIR, taps (P, M))
    y[t, k]  = sum_c v[t, c] e^{-2 pi i c k/M}  (= fft(v[t]))
so channel k is x mixed down from center frequency +k/M * fs and decimated
by M through the prototype low-pass (unit passband gain: a unit tone at a
channel center produces a unit-amplitude channel output).

Device mapping: the FIR and DFT FOLD INTO ONE MATMUL —
    y[t, k] = sum_{s,c} G[s*M + c, k] * xp[t - (P-1) + s, c]
with G[s*M+c, k] = W_M^{ck} * h[P-1-s, c], i.e. overlapping (P*M)-wide
frames of the phase rows times a constant (P*M, M) matrix: four real
(T, P*M) @ (P*M, M) matmuls (real/imag split), no per-phase shift
stack, no complex FFT.  The only cross-block state is the last P-1 phase
rows, which is exactly what :func:`parallel.halo.halo_exchange` passes
between time shards.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cognitive_radio_network_tpu.signal import filters
from cognitive_radio_network_tpu.signal.fft import matmul

__all__ = ["polyphase_taps", "channelize", "channelize_planes"]


def polyphase_taps(num_channels: int, taps_per_channel: int = 8) -> np.ndarray:
    """(P, M) float32 phase-decomposed prototype low-pass."""
    proto = filters.channelizer_prototype(num_channels, taps_per_channel)
    return proto.reshape(taps_per_channel, num_channels)


def _fir_dft_matrices(taps: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Combined FIR+DFT matrix G (P*M, M): G[s*M+c, k] = W_M^(ck) h[P-1-s, c].

    Constant-folded by XLA when ``taps`` is a constant."""
    p, m = taps.shape
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    wre = jnp.asarray(np.cos(ang).astype(np.float32))
    wim = jnp.asarray(np.sin(ang).astype(np.float32))
    t = jnp.flip(taps.astype(jnp.float32), axis=0)[:, :, None]  # (P, M, 1)
    gre = (wre[None] * t).reshape(p * m, m)
    gim = (wim[None] * t).reshape(p * m, m)
    return gre, gim


def _frames(rows: jax.Array, p: int) -> jax.Array:
    """Overlapping windows: rows (..., T + P - 1, M) -> (..., T, P*M)."""
    t = rows.shape[-2] - (p - 1)
    return jnp.concatenate(
        [rows[..., s : s + t, :] for s in range(p)], axis=-1
    )


def _channelize_rows(xr, xi, taps, history_r, history_i, precision):
    p, m = taps.shape
    gre, gim = _fir_dft_matrices(taps)
    fr = _frames(jnp.concatenate([history_r, xr], axis=-2), p)
    fi = _frames(jnp.concatenate([history_i, xi], axis=-2), p)

    def mm(a, b):
        return matmul(a, b, precision)

    yre = mm(fr, gre) - mm(fi, gim)
    yim = mm(fr, gim) + mm(fi, gre)
    return yre, yim


def channelize(
    x: jax.Array,
    taps: jax.Array,
    *,
    history: jax.Array | None = None,
    precision: str = "highest",
) -> jax.Array:
    """x: complex (..., T*M) wide stream -> (..., T, M) per-channel streams.

    ``history``: optional (..., P-1, M) phase rows from the previous block
    (overlap-save carry); if given, the FIR is seeded with them so block
    boundaries are seamless — this is the argument the halo exchange fills.
    """
    p, m = taps.shape
    xp = x.reshape(*x.shape[:-1], -1, m)
    if history is None:
        history = jnp.zeros((*xp.shape[:-2], p - 1, m), xp.dtype)
    yre, yim = _channelize_rows(
        jnp.real(xp).astype(jnp.float32),
        jnp.imag(xp).astype(jnp.float32),
        taps,
        jnp.real(history).astype(jnp.float32),
        jnp.imag(history).astype(jnp.float32),
        precision,
    )
    return (yre + 1j * yim).astype(jnp.complex64)


def channelize_planes(
    planes: jax.Array,
    taps: jax.Array,
    *,
    history: jax.Array | None = None,
    precision: str = "high",
) -> jax.Array:
    """Planes variant: (..., T*M, 2) -> (..., T, M, 2); no complex anywhere."""
    p, m = taps.shape
    xp = planes.reshape(*planes.shape[:-2], -1, m, 2)
    if history is None:
        history = jnp.zeros((*xp.shape[:-3], p - 1, m, 2), jnp.float32)
    yre, yim = _channelize_rows(
        xp[..., 0],
        xp[..., 1],
        taps,
        history[..., 0],
        history[..., 1],
        precision,
    )
    return jnp.stack([yre, yim], axis=-1)
