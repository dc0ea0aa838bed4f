"""The persistent XLA compile cache, kept in one fixed place."""
from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here; otherwise the cache is ``<checkout>/.jax_cache``
    (listed in .gitignore).  The path never depends on a temp name, pid or
    time, since it is part of the cache's key.

    Source locations are kept to one frame per op: a Pallas-Triton kernel
    carries its locations into the program's cache key, and with whole call
    stacks the same program called from two scripts would compile twice.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        CHECKOUT_CACHE.mkdir(exist_ok=True)
        path = str(CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    return path
