"""Persistent XLA compilation cache placement, shared by every entry point
(CLI, bench.py, chip_smoke.py, the test suite).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at a fixed path inside
the checkout, ``<checkout>/.jax_cache`` (git-ignored): the path is part of
the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = CHECKOUT_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    # Frame functions take seconds to compile; tiny helpers are not worth
    # a cache entry.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
