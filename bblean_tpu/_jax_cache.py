r"""Persistent JAX compilation cache for the device engines.

JAX ships its persistent compile cache disabled; without it every ``bb run
--engine batch`` pays the full compile bill again.  The device paths call
:func:`enable_persistent_cache` once before building any jitted program.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets no other directory;
- otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``): a fixed
  path, because the cache key includes it and a moving directory never hits.

Disable with ``BBLEAN_TPU_NO_JAX_CACHE=1``.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["default_cache_dir", "enable_persistent_cache"]

_DONE = False


def default_cache_dir() -> Path:
    r"""``<checkout>/.jax_cache``: the cache directory when the environment
    names none."""
    return Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_persistent_cache(min_compile_time_s: float = 2.0) -> None:
    global _DONE
    if _DONE or os.getenv("BBLEAN_TPU_NO_JAX_CACHE"):
        return
    _DONE = True
    import jax

    if not os.getenv("JAX_COMPILATION_CACHE_DIR"):
        cache = default_cache_dir()
        try:
            cache.mkdir(parents=True, exist_ok=True)
        except OSError:
            return  # read-only checkout: run without a persistent cache
        jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_s
    )
