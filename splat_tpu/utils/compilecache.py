"""Persistent XLA compilation cache.

The first compile of the 1080p tiled pipeline takes tens of seconds;
JAX can persist compiled executables keyed by an HLO hash, so a second
process start skips straight to execution.  Every user-facing entry
point (CLI, bench, viewer, chip_smoke.py) calls
:func:`enable_persistent_cache` before building jitted functions.

Where the cache lives:

1. ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself and this
   module sets no other directory;
2. otherwise ``<checkout>/.jax_cache`` — a fixed path, because the path
   is part of what makes a later run find the entries again
   (``.gitignore`` lists it).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Safe to call more than once.
    """
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # The pipeline's kernels are exactly the expensive-to-compile,
    # cheap-to-store artifacts the cache exists for; cache everything
    # that takes more than a second so even the small helper jits
    # (pair_stats, orbit steps) warm-start.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
