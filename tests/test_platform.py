"""utils/platform.py: the one sense-path selection point and the compile cache."""

import pytest

from cognitive_radio_network_tpu.utils import platform


@pytest.mark.parametrize(
    "device_platform, n, want",
    [
        ("cpu", 512, "ct_matmul"),
        ("cpu", 256, "ct_matmul"),
        ("cpu", 1024, "dft_matmul"),
        ("gpu", 512, "xla"),
        ("gpu", 2048, "xla"),
    ],
)
def test_sense_path_selection(monkeypatch, device_platform, n, want):
    monkeypatch.setattr(platform, "effective_platform", lambda: device_platform)
    assert platform.sense_fft_mode(n) == want


def test_unknown_platform_is_an_error(monkeypatch):
    monkeypatch.setattr(platform, "effective_platform", lambda: "metal")
    with pytest.raises(ValueError, match="no sense path"):
        platform.sense_fft_mode(512)


def test_effective_platform_follows_default_device():
    import jax

    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        assert platform.effective_platform() == "cpu"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert platform.compile_cache_dir() == str(tmp_path)
    try:
        assert platform.enable_compile_cache() == str(tmp_path)
        # a set variable is JAX's own setting: the helper leaves it alone
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from pathlib import Path

    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = Path(platform.__file__).resolve().parents[2]
    assert platform.compile_cache_dir() == str(root / ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert platform.enable_compile_cache() == str(root / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(root / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (root / ".gitignore").read_text().splitlines()
