"""Persistent XLA compile-cache setup.

Every entry point (the CLI pipeline, the benchmark, the chip smoke test,
the scripts) routes through :func:`enable_persistent_compile_cache`, so a
run finds what an earlier run compiled. ``JAX_COMPILATION_CACHE_DIR``
names the directory when it is set; otherwise the cache lives at the
fixed ``<checkout>/.jax_cache``. The path is part of what makes a cache
hit possible, so it is never derived from a temporary directory, a
process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["compile_cache_dir", "enable_persistent_compile_cache"]

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)


def enable_persistent_compile_cache() -> str:
    """Enable jax's persistent compile cache and return its directory.

    Programs of every size that took at least half a second to compile
    are cached, unless ``JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES`` or
    ``JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS`` say otherwise (jax
    reads both itself)."""
    import jax

    directory = compile_cache_dir()
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    if "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES" not in os.environ:
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return directory
