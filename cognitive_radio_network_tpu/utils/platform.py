"""Platform detection, the choice of the sense path, and the compile cache.

`jax.default_backend()` reports the process's highest-priority backend even
inside a `jax.default_device(...)` context, so code that picks a path by
backend alone would pick the GPU's path while the computation actually runs
on a CPU device (the scenario runtime's phy_placement="host" context).
The choice therefore goes through :func:`effective_platform`, in one place:
:func:`sense_fft_mode`.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = [
    "effective_platform",
    "sense_fft_mode",
    "compile_cache_dir",
    "enable_compile_cache",
]

# fixed, so that repeated runs from one checkout find their entries (the
# path is part of what the cache sees)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def effective_platform() -> str:
    """Platform of the device computations will actually land on: the
    `jax.default_device` override if one is active, else the default
    backend."""
    dd = jax.config.jax_default_device
    if dd is not None:
        try:
            return dd.platform
        except AttributeError:
            pass
    return jax.default_backend()


def sense_fft_mode(fft_length: int) -> str:
    """The spectrum mode of sense->classify where SenseConfig.fft_mode is
    None (signal/fft.spectrum_magnitude modes).

    GPU: "xla" — cuFFT; on an H100 it is the fastest sense path at every
    precision name (PERF.md), and it computes in f32.  CPU: the Cooley-Tukey
    matmul split where the 128-point factor applies, else the dense DFT.
    Any other platform is an error.
    """
    platform = effective_platform()
    if platform == "gpu":
        return "xla"
    if platform == "cpu":
        return "ct_matmul" if fft_length in (256, 512) else "dft_matmul"
    raise ValueError(f"no sense path for platform {platform!r}")


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache at :func:`compile_cache_dir`
    (JAX reads `JAX_COMPILATION_CACHE_DIR` itself, so a set variable is
    left alone) and cache every entry; returns the directory."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.05)
    return path
