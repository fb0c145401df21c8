"""Batched spectrum estimation.

The reference senses by running liquid-dsp's scalar 512-point FFT on one
buffer at a time and accumulating magnitude averages on the CPU
(CE_Predictive_Node.cpp:148-155).  Here the same math is expressed as large
batched matmuls:

* a length-N DFT is four real (B, N) @ (N, N) matmuls (real/imag split), or
  the Cooley-Tukey N1 x 128 split of ``mode="ct_matmul"``, which lets XLA
  fuse the magnitude + averaging + band-reduction epilogue;
* ``mode="xla"`` is ``jnp.fft.fft`` (cuFFT on a GPU).

All functions are shape-polymorphic over leading batch dims and jit-safe.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PRECISIONS",
    "matmul",
    "dft_matrices",
    "spectrum_magnitude",
    "averaged_magnitude_spectrum",
]

# Cooley-Tukey split used by mode="ct_matmul": N = N1 * 128 with a cheap
# radix-N1 first stage (N1 in {2, 4}: twiddles are +-1 / +-i -> adds only)
# and a 128-point DFT second stage as (rows, 128) @ (128, 128) matmuls.
# Cuts matmul flops per sample ~4x vs the dense (N, N) DFT at N=512.
_CT_N2 = 128


@functools.lru_cache(maxsize=16)
def _dft_matrices_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    # Build the angle in float64 then cast: for n<=4096 this keeps the DFT
    # matrix entries accurate to f32 ulp, which the golden tests rely on.
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def dft_matrices(n: int, dtype=jnp.float32) -> tuple[jax.Array, jax.Array]:
    """Real and imaginary parts of the forward DFT matrix ``exp(-2*pi*i*jk/n)``."""
    fre, fim = _dft_matrices_np(n)
    return jnp.asarray(fre, dtype), jnp.asarray(fim, dtype)


PRECISIONS = ("highest", "high", "default")


def _split_bf16(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """float32 x = hi + lo: hi is x rounded to its top 16 bits (exact in
    bfloat16), lo the remainder rounded to bfloat16.  Taken on the bits, not
    by an f32 -> bf16 -> f32 round trip, which XLA's GPU simplifier may fold
    away (excess precision), leaving lo = 0.  For finite x."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32) + jnp.uint32(0x8000)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000), jnp.float32)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def matmul(a: jax.Array, b: jax.Array, precision: str) -> jax.Array:
    """``a @ b`` in float32, by the algorithm a precision name stands for:

    * "highest": float32 products (``Precision.HIGHEST``), ~1e-6 relative;
    * "high": bf16_3x — both operands split into bfloat16 hi + lo parts,
      hi·hi + (hi·lo + lo·hi) with float32 accumulation, ~1e-5 relative;
    * "default": one bfloat16 pass with float32 accumulation, ~1e-2.

    Written with plain dtypes and the HIGHEST enum rather than a
    ``DotAlgorithmPreset`` or ``Precision.HIGH``: on a GPU ``HIGH`` and
    ``DEFAULT`` run in TF32 (~3e-4), and XLA drops a dot's algorithm
    attribute when it partitions a program over several devices, which
    turns a preset back into TF32 there.
    """
    f32 = jnp.float32
    if precision == "highest":
        return jnp.matmul(
            a, b, precision=jax.lax.Precision.HIGHEST, preferred_element_type=f32
        )
    if precision == "high":
        a_hi, a_lo = _split_bf16(a.astype(f32))
        b_hi, b_lo = _split_bf16(b.astype(f32))

        def mm(x, y):
            return jnp.matmul(x, y, preferred_element_type=f32)

        return mm(a_hi, b_hi) + (mm(a_hi, b_lo) + mm(a_lo, b_hi))
    if precision == "default":
        return jnp.matmul(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), preferred_element_type=f32
        )
    raise ValueError(f"unknown precision {precision!r}, expected one of {PRECISIONS}")


@functools.lru_cache(maxsize=16)
def _ct_twiddles_np(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """W_N^(k1*n2) over (k1, n2), N = n1*n2, in float64 -> f32."""
    k1 = np.arange(n1)[:, None]
    n2i = np.arange(n2)[None, :]
    ang = -2.0 * np.pi * k1 * n2i / (n1 * n2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _ct_spectrum_sq(xr: jax.Array, xi: jax.Array, precision: str) -> jax.Array:
    """|FFT|^2 via the N = n1 x 128 Cooley-Tukey split (n1 in {2, 4}).

    Stage 1: radix-n1 butterflies over x[n] = x[128*m1 + n2] — the
    length-n1 DFT twiddles are +-1 / +-i, so this is adds/swaps only.
    Stage 2: twiddle multiply by W_N^(k1*n2).
    Stage 3: length-128 DFT as four (rows*n1, 128) @ (128, 128)
    real-split matmuls.
    Output bin k = k1 + n1*k2 -> transpose (k1, k2) axes and reshape.
    """
    n = xr.shape[-1]
    n1 = n // _CT_N2
    lead = xr.shape[:-1]
    xr = xr.reshape(*lead, n1, _CT_N2)
    xi = xi.reshape(*lead, n1, _CT_N2)
    if n1 == 2:
        yr = jnp.stack([xr[..., 0, :] + xr[..., 1, :], xr[..., 0, :] - xr[..., 1, :]], -2)
        yi = jnp.stack([xi[..., 0, :] + xi[..., 1, :], xi[..., 0, :] - xi[..., 1, :]], -2)
    else:  # n1 == 4
        x0r, x1r, x2r, x3r = (xr[..., j, :] for j in range(4))
        x0i, x1i, x2i, x3i = (xi[..., j, :] for j in range(4))
        a_r, a_i = x0r + x2r, x0i + x2i  # x0 + x2
        b_r, b_i = x0r - x2r, x0i - x2i  # x0 - x2
        c_r, c_i = x1r + x3r, x1i + x3i  # x1 + x3
        d_r, d_i = x1r - x3r, x1i - x3i  # x1 - x3
        # k1 = 0: a+c; k1 = 2: a-c; k1 = 1: b - i*d; k1 = 3: b + i*d
        yr = jnp.stack([a_r + c_r, b_r + d_i, a_r - c_r, b_r - d_i], -2)
        yi = jnp.stack([a_i + c_i, b_i - d_r, a_i - c_i, b_i + d_r], -2)
    twr, twi = _ct_twiddles_np(n1, _CT_N2)
    twr = jnp.asarray(twr)
    twi = jnp.asarray(twi)
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    fre, fim = dft_matrices(_CT_N2)

    def mm(a, b):
        return matmul(a, b, precision)

    xre = mm(zr, fre) - mm(zi, fim)  # (..., n1, 128) indexed [k1, k2]
    xim = mm(zr, fim) + mm(zi, fre)
    sq = xre * xre + xim * xim
    # bin k = k1 + n1*k2: put k2 before k1, then flatten
    return jnp.swapaxes(sq, -1, -2).reshape(*lead, n)


def spectrum_magnitude(
    x: jax.Array, *, mode: str = "dft_matmul", precision: str = "high"
) -> jax.Array:
    """|FFT(x)| over the sample axis.

    x: complex (..., N) or float32 IQ planes (..., N, 2).
    Returns float32 (..., N) — the ``cabsf(buffer_F[i])`` of
    CE_Predictive_Node.cpp:153, batched.

    Modes:
      ``ct_matmul`` — Cooley-Tukey N1 x 128 factorization (radix-N1 adds
        + 128-point matmuls), ~4x fewer matmul flops at N=512; requires N
        in {256, 512} (falls back to dft_matmul else).
      ``dft_matmul`` — dense X = x @ F with the real/imag split
        (Xre = xr@Fre - xi@Fim, Xim = xr@Fim + xi@Fre): four (N, N) matmuls.
      ``xla`` — jnp.fft.fft (cuFFT on a GPU, where it is the fastest).
    ``precision``: a name of :data:`PRECISIONS` (see :func:`matmul`) —
    "highest" (f32 products, the strict bit-match mode), "high" (bf16_3x,
    ~1e-5 relative error, the default) or "default" (one bf16 pass, ~1e-2
    error).  The ``xla`` mode computes in f32 whatever the name.
    """
    from cognitive_radio_network_tpu.signal.iq import split_iq

    xr, xi = split_iq(x)
    n = xr.shape[-1]
    if mode == "xla":
        z = (xr + 1j * xi).astype(jnp.complex64)
        return jnp.abs(jnp.fft.fft(z, axis=-1)).astype(jnp.float32)
    if mode == "ct_matmul" and n // _CT_N2 in (2, 4) and n % _CT_N2 == 0:
        return jnp.sqrt(_ct_spectrum_sq(xr, xi, precision))
    if mode not in ("dft_matmul", "ct_matmul"):
        raise ValueError(f"unknown spectrum mode: {mode}")
    fre, fim = dft_matrices(n)

    def mm(a, b):
        return matmul(a, b, precision)

    xre = mm(xr, fre) - mm(xi, fim)
    xim = mm(xr, fim) + mm(xi, fre)
    return jnp.sqrt(xre * xre + xim * xim)


def averaged_magnitude_spectrum(
    blocks: jax.Array,
    *,
    averaging: int | None = None,
    mode: str = "dft_matmul",
    precision: str = "high",
) -> jax.Array:
    """Magnitude-average spectra over an averaging axis.

    blocks: complex (..., A, N) or planes (..., A, N, 2) — A consecutive FFT
    buffers per sense cycle.
    Returns float32 (..., N): ``fft_avg[i] = sum_a |X_a[i]| / A`` exactly as
    CE_Predictive_Node.cpp:152-154 (accumulate |X|/fft_averaging).

    Accumulation order note: the reference adds |X|/A buffer-by-buffer in f32;
    we sum then divide, which differs only by f32 rounding. The golden tests
    bound this below the decision SNR margin.
    """
    mags = spectrum_magnitude(blocks, mode=mode, precision=precision)
    if averaging is not None and mags.shape[-2] != averaging:
        raise ValueError(
            f"expected averaging axis {averaging}, got shape {blocks.shape}"
        )
    return jnp.mean(mags, axis=-2)
