"""Sense spectrum modes and the window-extraction helper (CPU test mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cognitive_radio_network_tpu.signal.bands import band_features
from cognitive_radio_network_tpu.signal.fft import averaged_magnitude_spectrum


def _planar(iq):
    """(C, A, N, 2) planes -> buffers-flat planar (C*A, N) device arrays."""
    return (
        jnp.asarray(np.ascontiguousarray(iq[..., 0]).reshape(-1, 512)),
        jnp.asarray(np.ascontiguousarray(iq[..., 1]).reshape(-1, 512)),
    )


class TestFusedSenseCT:
    """The sense spectrum modes (signal/fft.py) and their selection."""

    def _ref(self, iq_planes):
        avg = averaged_magnitude_spectrum(
            jnp.asarray(iq_planes), mode="dft_matmul", precision="highest"
        )
        return np.asarray(avg), np.asarray(band_features(avg))

    def test_ct_xla_mode_matches_dense(self, rng):
        """signal/fft.py mode='ct_matmul' == dense DFT matmul (pure XLA)."""
        iq = rng.standard_normal((4, 10, 512, 2)).astype(np.float32)
        dense = averaged_magnitude_spectrum(
            jnp.asarray(iq), mode="dft_matmul", precision="highest"
        )
        ct = averaged_magnitude_spectrum(
            jnp.asarray(iq), mode="ct_matmul", precision="highest"
        )
        np.testing.assert_allclose(
            np.asarray(ct), np.asarray(dense), rtol=1e-4, atol=1e-5
        )

    def test_fft_mode_matches_dense(self, rng):
        """mode='xla' (jnp.fft, the GPU's choice) == dense DFT matmul, from
        a planar tuple."""
        iq = rng.standard_normal((5, 10, 512, 2)).astype(np.float32)
        want_avg, want_feats = self._ref(iq)
        xr, xi = (x.reshape(5, 10, 512) for x in _planar(iq))
        avg = averaged_magnitude_spectrum((xr, xi), mode="xla")
        np.testing.assert_allclose(np.asarray(avg), want_avg, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(band_features(avg)), want_feats, rtol=1e-4
        )

    def test_sense_classify_planar_equals_planes(self, rng):
        """The full pipeline accepts planar tuples and agrees bit-for-bit on
        decisions with the planes path (CPU: both use the XLA graph)."""
        from cognitive_radio_network_tpu.models import SenseConfig, sense_classify
        from cognitive_radio_network_tpu.signal.mlp import reference_weights

        cfg = SenseConfig()
        iq = rng.standard_normal((6, 10, 512, 2)).astype(np.float32) * 0.1
        params = reference_weights()
        r1 = sense_classify(jnp.asarray(iq), params, cfg)
        r2 = sense_classify(_planar(iq), params, cfg)
        np.testing.assert_array_equal(
            np.asarray(r1["decision"]), np.asarray(r2["decision"])
        )
        np.testing.assert_allclose(
            np.asarray(r1["features"]), np.asarray(r2["features"]), rtol=1e-5
        )

    @pytest.mark.parametrize("platform, mode", [("cpu", "ct_matmul"), ("gpu", "xla")])
    def test_sense_classify_follows_platform_choice(self, rng, monkeypatch, platform, mode):
        """SenseConfig.fft_mode=None takes utils/platform's choice; the
        result equals that mode named explicitly."""
        from cognitive_radio_network_tpu.models import SenseConfig, sense_classify
        from cognitive_radio_network_tpu.models import sense as sense_mod
        from cognitive_radio_network_tpu.signal.mlp import reference_weights
        from cognitive_radio_network_tpu.utils import platform as plat

        monkeypatch.setattr(plat, "effective_platform", lambda: platform)
        monkeypatch.setattr(sense_mod, "sense_fft_mode", plat.sense_fft_mode)
        iq = _planar(rng.standard_normal((3, 10, 512, 2)).astype(np.float32))
        params = reference_weights()
        auto = sense_classify(iq, params, SenseConfig())
        named = sense_classify(iq, params, SenseConfig(fft_mode=mode))
        for k in ("avg_spectrum", "features", "decision"):
            np.testing.assert_array_equal(np.asarray(auto[k]), np.asarray(named[k]))

    def test_bf16_input_mode(self, rng):
        """bf16 planar ingest (half the input bytes) stays within 2e-2 of
        the f32 features (bf16 keeps 8 mantissa bits; a band sum of 10-33
        bins averages their rounding)."""
        from cognitive_radio_network_tpu.models import SenseConfig, sense_classify
        from cognitive_radio_network_tpu.signal.mlp import reference_weights

        iq = rng.standard_normal((4, 10, 512, 2)).astype(np.float32)
        xr, xi = _planar(iq)
        params = reference_weights()
        for mode in ("ct_matmul", "xla"):
            want = sense_classify((xr, xi), params, SenseConfig(fft_mode=mode))
            got = sense_classify(
                (xr.astype(jnp.bfloat16), xi.astype(jnp.bfloat16)),
                params,
                SenseConfig(fft_mode=mode, precision="default"),
            )
            np.testing.assert_allclose(
                np.asarray(got["features"]), np.asarray(want["features"]), rtol=2e-2
            )

    @pytest.mark.parametrize(
        "name, lo, hi",
        [("highest", 0.0, 1e-5), ("high", 1e-8, 5e-5), ("default", 5e-4, 2e-2)],
    )
    def test_precision_names_compute_their_algorithm(self, rng, name, lo, hi):
        """signal/fft.matmul computes what each name says (f32, bf16_3x,
        one bf16 pass) on every backend, and every matmul mode takes it."""
        from cognitive_radio_network_tpu.signal.fft import matmul

        a = rng.standard_normal((64, 128)).astype(np.float32)
        b = rng.standard_normal((128, 128)).astype(np.float32)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        got = np.asarray(jax.jit(lambda x, y: matmul(x, y, name))(a, b))
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert lo <= err <= hi, err
        iq = rng.standard_normal((2, 10, 512, 2)).astype(np.float32)
        want_avg, _ = self._ref(iq)
        for mode in ("ct_matmul", "dft_matmul"):
            avg = averaged_magnitude_spectrum(jnp.asarray(iq), mode=mode, precision=name)
            err = np.abs(np.asarray(avg) - want_avg).max() / want_avg.max()
            assert err <= hi, (mode, err)


    def test_bf16_split_is_taken_on_the_bits(self, rng):
        """x = hi + lo to ~2^-16, with no f32 -> bf16 -> f32 round trip in
        the graph (XLA's GPU simplifier folds one away, zeroing lo)."""
        from cognitive_radio_network_tpu.signal.fft import _split_bf16

        x = jnp.asarray(rng.standard_normal(4096).astype(np.float32) * 1e3)
        hi, lo = _split_bf16(x)
        assert hi.dtype == lo.dtype == jnp.bfloat16
        back = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        err = np.abs(back - np.asarray(x, np.float64)) / np.abs(np.asarray(x))
        assert err.max() < 2.0**-16
        assert np.abs(np.asarray(lo, np.float32)).max() > 0
        eqns = jax.make_jaxpr(_split_bf16)(x).jaxpr.eqns
        assert "bitcast_convert_type" in {e.primitive.name for e in eqns}
        converts = [e for e in eqns if e.primitive.name == "convert_element_type"]
        assert all(e.params["new_dtype"] == jnp.bfloat16 for e in converts)


class TestExtractWindows:
    """Dynamic-offset window extraction (ops/extract.py) — the gather
    feeding the OFDM rx graphs, one vmapped dynamic-slice path on every
    platform."""

    def test_rows_match_slices(self, rng):
        from cognitive_radio_network_tpu.ops.extract import extract_windows

        n, wlen = 50000, 470
        rr = rng.standard_normal(n).astype(np.float32)
        ri = rng.standard_normal(n).astype(np.float32)
        offs = rng.integers(0, n - wlen, 13).astype(np.int32)
        wr, wi = extract_windows(jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(offs), wlen)
        for k, o in enumerate(offs):
            np.testing.assert_array_equal(np.asarray(wr)[k], rr[o : o + wlen])
            np.testing.assert_array_equal(np.asarray(wi)[k], ri[o : o + wlen])

    def test_offsets_clipped(self, rng):
        from cognitive_radio_network_tpu.ops.extract import extract_windows

        n, wlen = 4096, 512
        rr = rng.standard_normal(n).astype(np.float32)
        ri = rng.standard_normal(n).astype(np.float32)
        offs = np.asarray([-7, n - 3, n + 100, 0], np.int32)
        wr, _ = extract_windows(jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(offs), wlen)
        for k, o in enumerate(offs):
            oc = min(max(int(o), 0), n - wlen)
            np.testing.assert_array_equal(np.asarray(wr)[k], rr[oc : oc + wlen])
