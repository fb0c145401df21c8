"""Channel band-energy features with the reference's exact bin semantics.

The reference sums *amplitudes* of DC-centered, **unshifted** FFT bins per
channel, then squares the sum to get a "power" feature
(CE_Predictive_Node.cpp:173-197):

* CH1 (833 MHz, the DC band): bins [0, 16) union [496, 511)  — note the upper
  loop runs ``i < 511`` so bin 511 is *excluded*: 15 bins, a reference quirk
  we preserve bit-for-bit;
* CH2 (835 MHz, +2 MHz ~ bin 78.8 @ 13 MS/s / 512): bins [55, 85);
* CH3 (838 MHz, +5 MHz ~ bin 196.9): bins [189, 222);
* noise floor: bins [300, 310).

Feature vector order matches ``Features_Buffer[1..4] = {NF, CH1, CH2, CH3}``
(CE_Predictive_Node.cpp:200).

Device mapping: the band sums are one (..., N) @ (N, 4) matmul with a 0/1
indicator matrix — an epilogue to the DFT matmuls of
:mod:`cognitive_radio_network_tpu.signal.fft`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SensingBands", "DEFAULT_BANDS", "band_matrix", "band_features"]


@dataclasses.dataclass(frozen=True)
class SensingBands:
    """Bin ranges (half-open [lo, hi) intervals) for each feature column.

    Column order is the feature order: (noise_floor, ch1, ch2, ch3).
    """

    fft_length: int = 512
    noise_floor: tuple[tuple[int, int], ...] = ((300, 310),)
    ch1: tuple[tuple[int, int], ...] = ((0, 16), (496, 511))  # 511 excluded: quirk
    ch2: tuple[tuple[int, int], ...] = ((55, 85),)
    ch3: tuple[tuple[int, int], ...] = ((189, 222),)

    @property
    def columns(self) -> tuple[tuple[tuple[int, int], ...], ...]:
        return (self.noise_floor, self.ch1, self.ch2, self.ch3)

    @staticmethod
    def for_grid(
        fft_length: int,
        sample_rate_hz: float,
        center_hz: float,
        channels_hz: tuple[float, ...],
        channel_bw_hz: float,
        noise_offset_hz: float,
    ) -> "SensingBands":
        """Derive band bin maps for arbitrary grids (beyond the 512/13e6 default).

        Bins are unshifted (DC at bin 0, negative freqs wrap to the top), like
        the reference's direct indexing of the liquid FFT output.
        """

        def bins_for(f_lo: float, f_hi: float) -> tuple[tuple[int, int], ...]:
            df = sample_rate_hz / fft_length
            lo = int(np.floor((f_lo - center_hz) / df))
            hi = int(np.ceil((f_hi - center_hz) / df))
            out = []
            if lo < 0 and hi > 0:
                out.append((0, hi))
                out.append((fft_length + lo, fft_length))
            elif lo < 0:
                out.append((fft_length + lo, fft_length + hi))
            else:
                out.append((lo, hi))
            return tuple(out)

        half = channel_bw_hz / 2
        cols = [bins_for(c - half, c + half) for c in channels_hz]
        nf = bins_for(center_hz + noise_offset_hz - half / 2, center_hz + noise_offset_hz + half / 2)
        return SensingBands(fft_length, nf, *cols)


DEFAULT_BANDS = SensingBands()


@functools.lru_cache(maxsize=16)
def _band_matrix_np(bands: SensingBands) -> np.ndarray:
    m = np.zeros((bands.fft_length, len(bands.columns)), dtype=np.float32)
    for col, ranges in enumerate(bands.columns):
        for lo, hi in ranges:
            m[lo:hi, col] = 1.0
    return m


def band_matrix(bands: SensingBands = DEFAULT_BANDS, dtype=jnp.float32) -> jax.Array:
    """(N, 4) 0/1 indicator matrix; column order (NF, CH1, CH2, CH3)."""
    return jnp.asarray(_band_matrix_np(bands), dtype)


def band_features(
    avg_spectrum: jax.Array, bands: SensingBands = DEFAULT_BANDS
) -> jax.Array:
    """Features ``[NF, CH1, CH2, CH3]`` = (sum of band amplitudes)**2.

    avg_spectrum: float (..., N) averaged magnitude spectrum (already >= 0;
    the reference re-applies cabsf to the real average at
    CE_Predictive_Node.cpp:174 — a no-op we mirror with abs for safety).
    Returns float32 (..., 4).
    """
    m = band_matrix(bands)
    sums = jnp.matmul(
        jnp.abs(avg_spectrum).astype(jnp.float32), m, preferred_element_type=jnp.float32
    )
    return sums * sums
