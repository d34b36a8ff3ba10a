"""Persistent XLA compile cache location.

Compiling the receiver's programs takes seconds to minutes per plan, so the
entry points (``cli.main``, ``bench.py``, ``chip_smoke.py``) keep compiled
executables in JAX's persistent cache. The path is part of the cache key,
so it is a fixed directory inside the checkout, never a temporary name.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here; otherwise the cache goes to ``CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
