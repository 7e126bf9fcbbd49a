"""Persistent XLA compilation cache.

Every program in this framework is shape-stable across runs (epoch batches
are padded to fixed sizes precisely so the compile count is O(1) per
configuration), so caching compiled executables on disk lets every run
after the first skip compilation.

The cache lives where JAX_COMPILATION_CACHE_DIR says when that variable is
set (JAX reads it itself; this module then sets no directory), and
otherwise in the fixed `.jax_cache/` at the root of the checkout: the path
is part of the cache key, so a directory that moves never hits.

Enabled by the CLI, bench harness, and driver entry points; opt out with
GPS_SDR_SIM_NO_CACHE=1.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")
_done = False


def cache_dir() -> str:
    """The directory enable() points the cache at."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable():
    global _done
    if _done or os.environ.get("GPS_SDR_SIM_NO_CACHE") == "1":
        return
    _done = True
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if path == DEFAULT_DIR:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
