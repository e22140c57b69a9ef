"""Per-platform choices, made in one place.

* :func:`interpret_kernels` - whether a Pallas kernel runs compiled (on a
  GPU) or through the Pallas interpreter (on the CPU, the test path);
  any other platform has no kernel route and raises.
* :func:`production_platform` - whether the CLI's default stack is the
  production one (frozen rk2, freeze window, compensated f32, window
  kernel): on a GPU.
* :func:`enable_compile_cache` - JAX's persistent compilation cache:
  ``JAX_COMPILATION_CACHE_DIR`` when it is set, else a fixed
  ``.jax_cache`` at the checkout root (the cache key includes the path,
  so the directory must not move between runs).
"""

from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT_ROOT = pathlib.Path(__file__).resolve().parent.parent


def interpret_kernels(platform: str | None = None) -> bool:
    """True on the CPU, False on a GPU; raises on any other platform."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(f"no Pallas kernel route for platform {platform!r}")


def production_platform(platform: str | None = None) -> bool:
    """Whether the production stack is the default on this platform."""
    return (platform or jax.default_backend()) == "gpu"


def compile_cache_dir() -> str:
    """The persistent compilation cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT_ROOT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
