"""Persistent XLA compilation cache.

The fused transport loops take minutes to compile; caching compiled
executables across processes makes reruns (tests, pipeline stages, bench)
start in seconds.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and that
directory is the cache. Otherwise the cache is ``<checkout>/.jax_cache``:
a fixed path, since the path is part of the cache key.
"""

import os

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")

_ENABLED = False


def enable_compile_cache():
    """Turn the persistent cache on (idempotent); returns its directory."""
    global _ENABLED
    import jax
    if not _ENABLED:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _ENABLED = True
    return jax.config.jax_compilation_cache_dir
