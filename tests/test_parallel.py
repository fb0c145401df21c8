"""Channelizer + sharded pipeline tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cognitive_radio_network_tpu.signal.channelizer import (
    channelize,
    channelize_planes,
    polyphase_taps,
)
from cognitive_radio_network_tpu.signal.iq import to_planes, from_planes
from cognitive_radio_network_tpu.parallel import (
    MeshSpec,
    make_mesh,
    sharded_channelize,
    WidebandConfig,
    wideband_sense,
)


def _tone(freq_norm, n):
    return np.exp(2j * np.pi * freq_norm * np.arange(n)).astype(np.complex64)


class TestChannelizer:
    def test_tone_lands_in_its_channel(self):
        m, p, t = 16, 8, 256
        taps = jnp.asarray(polyphase_taps(m, p))
        k = 5
        x = _tone(k / m, t * m)
        y = np.asarray(channelize(jnp.asarray(x), taps))  # (T, M)
        steady = np.abs(y[p:])  # skip filter warmup
        power = (steady**2).mean(axis=0)
        assert power[k] > 0.5
        others = np.delete(power, k)
        assert others.max() < 1e-3 * power[k]

    def test_offset_tone_frequency(self):
        """Tone at (k + delta)/M shows up in channel k rotating at delta per
        output sample."""
        m, p, t = 16, 8, 512
        taps = jnp.asarray(polyphase_taps(m, p))
        k, delta = 3, 0.1  # delta in channel-rate cycles/sample
        x = _tone((k + delta) / m, t * m)
        y = np.asarray(channelize(jnp.asarray(x), taps))[:, k]
        ph = np.angle(y[p + 1 :] * np.conj(y[p:-1]))
        est = np.median(ph) / (2 * np.pi)
        assert abs(est - delta) < 0.01

    def test_history_seam(self, rng):
        """Splitting a stream into blocks with history carry == one-shot."""
        m, p = 8, 8
        taps = jnp.asarray(polyphase_taps(m, p))
        x = (rng.standard_normal(64 * m) + 1j * rng.standard_normal(64 * m)).astype(
            np.complex64
        )
        full = np.asarray(channelize(jnp.asarray(x), taps))
        xp = x.reshape(-1, m)
        half = 32
        y1 = channelize(jnp.asarray(x[: half * m]), taps)
        hist = jnp.asarray(xp[half - (p - 1) : half])
        y2 = channelize(jnp.asarray(x[half * m :]), taps, history=hist)
        stitched = np.concatenate([np.asarray(y1), np.asarray(y2)])
        np.testing.assert_allclose(stitched, full, rtol=1e-4, atol=1e-5)

    def test_planes_matches_complex(self, rng):
        m = 8
        taps = jnp.asarray(polyphase_taps(m, 8))
        x = (rng.standard_normal(32 * m) + 1j * rng.standard_normal(32 * m)).astype(
            np.complex64
        )
        yc = np.asarray(channelize(jnp.asarray(x), taps))
        yp = np.asarray(channelize_planes(jnp.asarray(to_planes(x)), taps))
        np.testing.assert_allclose(from_planes(yp), yc, rtol=1e-4, atol=1e-5)


class TestShardedChannelize:
    def test_matches_single_device(self, rng):
        m, p = 16, 8
        taps = jnp.asarray(polyphase_taps(m, p))
        t = 64 * 8  # divisible by 8 time shards
        x = (rng.standard_normal(t * m) + 1j * rng.standard_normal(t * m)).astype(
            np.complex64
        )
        planes = jnp.asarray(to_planes(x))
        want = np.asarray(channelize_planes(planes, taps))

        mesh = make_mesh(MeshSpec(time=8))
        got = np.asarray(sharded_channelize(planes, taps, mesh))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_batched_data_parallel(self, rng):
        m, p = 8, 4
        taps = jnp.asarray(polyphase_taps(m, p))
        t = 32 * 4
        xb = (
            rng.standard_normal((2, t * m)) + 1j * rng.standard_normal((2, t * m))
        ).astype(np.complex64)
        planes = jnp.asarray(to_planes(xb))
        want = np.asarray(channelize_planes(planes, taps))

        mesh = make_mesh(MeshSpec(time=4, data=2))
        got = np.asarray(
            sharded_channelize(planes, taps, mesh, batch_axis="data")
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


class TestWideband:
    def test_energy_detector_finds_active_channels(self, rng):
        cfg = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=64)
        m = cfg.num_channels
        t = 64 * 8  # 8 cycles of 64, divisible by 4 time shards
        active = [2, 7, 11]
        x = 0.001 * (
            rng.standard_normal(t * m) + 1j * rng.standard_normal(t * m)
        ).astype(np.complex64)
        for k in active:
            x += _tone(k / m, t * m)
        planes = jnp.asarray(to_planes(x))

        mesh = make_mesh(MeshSpec(time=4, channel=2))
        res = wideband_sense(planes, jnp.asarray(cfg.taps()), mesh, cfg)
        occ = np.asarray(res["occupied"])  # (C, M)
        # ignore the first cycle (filter warmup)
        occ = occ[1:]
        for k in range(m):
            if k in active:
                assert occ[:, k].all(), f"channel {k} should be occupied"
            else:
                assert not occ[:, k].any(), f"channel {k} should be free"


class TestPackedWidebandEnergy:
    def test_matches_channelize_reference(self, rng):
        """The lane-packed energy fast path equals channelize -> |.|^2 ->
        block-mean (same FIR+DFT matrix, different data layout)."""
        import jax.numpy as jnp

        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            wideband_energy_packed,
        )
        from cognitive_radio_network_tpu.signal.channelizer import (
            channelize_planes,
            polyphase_taps,
        )

        cfg = WidebandConfig()  # M=64, P=8, block_len=128
        t_total = 4 * cfg.block_len
        planes = rng.standard_normal((t_total * 64, 2)).astype(np.float32)
        taps = jnp.asarray(polyphase_taps(64, 8))
        got = wideband_energy_packed(
            jnp.asarray(planes[:, 0].copy()),
            jnp.asarray(planes[:, 1].copy()),
            taps,
            cfg,
            precision="highest",
        )
        chan = np.asarray(
            channelize_planes(jnp.asarray(planes), taps, precision="highest")
        )
        power = chan[..., 0] ** 2 + chan[..., 1] ** 2
        want = power.reshape(-1, cfg.block_len, 64).mean(axis=1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-6)

    def test_sharded_packed_equals_single_device(self, rng):
        """Time-sharded packed energy (one-packed-row ppermute halo) is
        bit-identical to the single-device packed path — seams between
        shards carry the FIR state exactly."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            sharded_wideband_energy_packed,
            wideband_energy_packed,
        )
        from cognitive_radio_network_tpu.signal.channelizer import polyphase_taps

        cfg = WidebandConfig()
        t_total = 8 * cfg.block_len  # 8 cycles -> 2 per shard on 4 devices
        xr = jnp.asarray(rng.standard_normal(t_total * 64).astype(np.float32))
        xi = jnp.asarray(rng.standard_normal(t_total * 64).astype(np.float32))
        taps = jnp.asarray(polyphase_taps(64, 8))
        single = wideband_energy_packed(xr, xi, taps, cfg, precision="highest")
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("time",))
        sharded = jax.jit(
            lambda a, b: sharded_wideband_energy_packed(
                a, b, mesh, cfg, precision="highest"
            )
        )(xr, xi)
        np.testing.assert_allclose(
            np.asarray(sharded), np.asarray(single), rtol=1e-6, atol=1e-9
        )

    def test_selected_wideband_matches_numpy_oracle(self, rng):
        """make_wideband_fn (the one wideband path) at M=64 on a
        one-device mesh equals the independent numpy transliteration."""
        import jax
        import jax.numpy as jnp

        from chip_gates import wideband_energy_numpy
        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            make_wideband_fn,
        )

        cfg = WidebandConfig(precision="highest")
        t_total = 8 * cfg.block_len
        planes = rng.standard_normal((t_total * 64, 2)).astype(np.float32)
        mesh = make_mesh(MeshSpec(), jax.devices()[:1])
        got = make_wideband_fn(mesh, cfg)(jnp.asarray(planes))["energy"]
        want = wideband_energy_numpy(planes[:, 0], planes[:, 1], cfg.taps(), cfg)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-9)

    def test_sharded_packed_history_seam(self, rng):
        """On 4 devices every shard after the first starts its FIR from the
        previous shard's tail (a nonzero seam carried by ppermute): each
        shard's energies equal the history-seeded numpy oracle."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from chip_gates import wideband_energy_numpy
        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            sharded_wideband_energy_packed,
        )

        cfg = WidebandConfig()
        m, shards = cfg.num_channels, 4
        seg = 2 * cfg.block_len * m  # wide samples per shard
        xr = rng.standard_normal(shards * seg).astype(np.float32)
        xi = rng.standard_normal(shards * seg).astype(np.float32)
        mesh = Mesh(np.array(jax.devices()[:shards]), ("time",))
        got = np.asarray(
            jax.jit(
                lambda a, b: sharded_wideband_energy_packed(
                    a, b, mesh, cfg, precision="highest"
                )
            )(jnp.asarray(xr), jnp.asarray(xi))
        ).reshape(shards, -1, m)
        taps = cfg.taps()
        for k in range(shards):
            body = slice(k * seg, (k + 1) * seg)
            hist = None if k == 0 else (xr[:body.start], xi[:body.start])
            want = wideband_energy_numpy(xr[body], xi[body], taps, cfg, hist)
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-9)
        # the seam matters: the rest-from-zero oracle differs on shard 1
        rest = wideband_energy_numpy(xr[seg : 2 * seg], xi[seg : 2 * seg], taps, cfg)
        assert not np.allclose(got[1], rest, rtol=1e-5, atol=1e-9)

    @pytest.mark.parametrize(
        "precision, marker",
        [
            ("highest", "operand_precision={highest,highest}"),
            ("high", "bf16["),
            ("default", "bf16["),
        ],
    )
    def test_precision_survives_partitioning(self, precision, marker):
        """The 64-channel wideband program on a (time=2, channel=2) mesh keeps
        each precision name's arithmetic after XLA partitions it (a
        DotAlgorithmPreset is dropped there, and a GPU then runs TF32)."""
        import jax
        import jax.numpy as jnp

        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            make_wideband_fn,
        )

        cfg = WidebandConfig(precision=precision)
        mesh = make_mesh(MeshSpec(time=2, channel=2))
        planes = jnp.zeros((4 * cfg.block_len * 64, 2), jnp.float32)
        text = make_wideband_fn(mesh, cfg).lower(planes).compile().as_text()
        dots = [ln for ln in text.splitlines() if " dot(" in ln]
        assert dots
        if precision == "highest":
            assert all(marker in ln for ln in dots), dots
        else:
            # the bf16 rounding of the operands is in the partitioned
            # program (a CPU then runs the dot itself in f32)
            assert marker in text and "operand_precision" not in text

    def test_wideband_sense_routes_energy_fast_path(self, rng):
        """wideband_sense's unbatched time-sharded case (packed fast path,
        no channelized IQ materialized) matches the materializing
        channelizer path, planes and planar-tuple inputs alike."""
        import jax.numpy as jnp

        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            wideband_sense,
        )

        cfg = WidebandConfig()
        t_total = 8 * cfg.block_len
        planes = rng.standard_normal((t_total * 64, 2)).astype(np.float32)
        taps = jnp.asarray(cfg.taps())
        mesh = make_mesh(MeshSpec(time=4, channel=2))
        fast = wideband_sense(jnp.asarray(planes), taps, mesh, cfg)
        planar = wideband_sense(
            (jnp.asarray(planes[:, 0].copy()), jnp.asarray(planes[:, 1].copy())),
            taps, mesh, cfg,
        )
        # expected energies via the materializing channelizer
        from cognitive_radio_network_tpu.signal.channelizer import (
            channelize_planes,
        )

        chan = np.asarray(channelize_planes(jnp.asarray(planes), taps))
        power = chan[..., 0] ** 2 + chan[..., 1] ** 2
        want = power.reshape(-1, cfg.block_len, 64).mean(axis=1)
        np.testing.assert_allclose(
            np.asarray(fast["energy"]), want, rtol=2e-4, atol=1e-7
        )
        for k in ("energy", "noise"):
            np.testing.assert_allclose(
                np.asarray(planar[k]), np.asarray(fast[k]), rtol=1e-6, atol=0
            )


class TestBatchedWidebandFastPath:
    """Round-3 review item #6: the batched (data-parallel) wideband case
    must ride the lane-packed energy fast path, not the materializing
    channelizer — and match the single-device formulation per row."""

    def test_batched_matches_per_row_single_device(self, rng):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from cognitive_radio_network_tpu.parallel.wideband import (
            WidebandConfig,
            wideband_energy_packed,
            wideband_sense,
        )

        cfg = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=8)
        taps = jnp.asarray(cfg.taps())
        mesh = Mesh(
            np.array(jax.devices()[:8]).reshape(2, 4), ("data", "time")
        )
        b, t = 4, 64  # 4 streams of 64 phase-rows (4 cycles)
        planes = rng.standard_normal((b, t * cfg.num_channels, 2)).astype(
            np.float32
        )
        out = wideband_sense(
            jnp.asarray(planes), taps, mesh, cfg, batch_axis="data"
        )
        got = np.asarray(out["energy"])
        assert got.shape == (b, t // cfg.block_len, cfg.num_channels)
        for i in range(b):
            ref = np.asarray(
                wideband_energy_packed(
                    jnp.asarray(planes[i, :, 0]),
                    jnp.asarray(planes[i, :, 1]),
                    taps,
                    cfg,
                )
            )
            np.testing.assert_allclose(got[i], ref, rtol=2e-3, atol=1e-5)

    def test_batched_avoids_channelizer(self, rng, monkeypatch):
        """The materializing channelizer must NOT be called for the
        batched divisible case."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh
        import cognitive_radio_network_tpu.parallel.wideband as wb

        cfg = wb.WidebandConfig(num_channels=16, taps_per_channel=8, block_len=8)
        taps = jnp.asarray(cfg.taps())
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "time"))
        called = []
        monkeypatch.setattr(
            wb,
            "sharded_channelize",
            lambda *a, **k: called.append(1) or (_ for _ in ()).throw(
                AssertionError("channelizer fallback used")
            ),
        )
        planes = rng.standard_normal((4, 64 * 16, 2)).astype(np.float32)
        wb.wideband_sense(jnp.asarray(planes), taps, mesh, cfg, batch_axis="data")
        assert not called
