"""Constellation mapping: the liquid ``modulation_scheme`` equivalents.

Gray-coded unit-energy constellations for the schemes the reference's config
layer accepts (qam4 default, qam16 in predictive_model.cfg:79, plus the rest
of the usual ladder).  Fully batched: modulate is a gather, hard demod is a
per-axis slicer (square QAM) / phase slicer (PSK), and everything works under
vmap/jit so demod stays inside the rx graph.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SCHEMES", "bits_per_symbol", "constellation", "modulate", "demodulate"]

SCHEMES = ("bpsk", "qpsk", "qam4", "psk8", "qam16", "qam64", "qam256")

_BPS = {
    "bpsk": 1,
    "qpsk": 2,
    "qam4": 2,
    "psk8": 3,
    "qam16": 4,
    "qam64": 6,
    "qam256": 8,
}


def bits_per_symbol(scheme: str) -> int:
    return _BPS[scheme]


def _gray(n: int) -> int:
    return n ^ (n >> 1)


@functools.lru_cache(maxsize=None)
def _constellation_np(scheme: str) -> np.ndarray:
    bps = _BPS[scheme]
    m = 1 << bps
    if scheme == "bpsk":
        pts = np.array([1.0 + 0j, -1.0 + 0j])
    elif scheme in ("qpsk", "qam4"):
        # Gray 2-bit: bit0 -> I sign, bit1 -> Q sign.
        pts = np.array(
            [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], dtype=np.complex128
        ) / np.sqrt(2)
    elif scheme == "psk8":
        # position k on the circle carries symbol gray(k) so neighbors differ
        # by one bit
        pts = np.zeros(8, np.complex128)
        for k in range(8):
            pts[_gray(k)] = np.exp(1j * (2 * np.pi * k / 8 + np.pi / 8))
    else:
        # square gray QAM: split bits evenly between I (MSBs) and Q (LSBs)
        half = bps // 2
        l = 1 << half
        pam = 2 * np.arange(l) - (l - 1)  # levels
        # gray index g at level position p: level_of_gray[gray(p)] = pam[p]
        level_of = np.zeros(l)
        for p in range(l):
            level_of[_gray(p)] = pam[p]
        pts = np.zeros(m, np.complex128)
        for s in range(m):
            i_bits, q_bits = s >> half, s & (l - 1)
            pts[s] = level_of[i_bits] + 1j * level_of[q_bits]
        pts /= np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts.astype(np.complex64)


def constellation(scheme: str) -> jax.Array:
    return jnp.asarray(_constellation_np(scheme))


def modulate(scheme: str, symbols: jax.Array) -> jax.Array:
    """Symbol indices (..., S) int -> complex64 points."""
    return constellation(scheme)[symbols]


def demodulate(scheme: str, x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Hard demod: returns (symbol indices int32, evm per symbol float32).

    Min-distance over the constellation — one (..., S, M) reduction the
    compiler fuses (M <= 256).
    """
    pts = constellation(scheme)
    d2 = jnp.abs(x[..., None] - pts) ** 2
    idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
    # the distance at the argmin IS the min — a reduction, where a
    # take_along_axis gather would add an index pass
    evm = jnp.min(d2, axis=-1)
    return idx, evm.astype(jnp.float32)
