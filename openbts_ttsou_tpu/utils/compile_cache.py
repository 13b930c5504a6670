"""Where JAX keeps its persistent compilation cache.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself, so when that variable is
set nothing is configured here. Otherwise the cache lives at the fixed
path `<repo>/.jax_cache`: the directory is part of the cache key, so a
path that moved between runs would never hit.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return REPO_CACHE_DIR
