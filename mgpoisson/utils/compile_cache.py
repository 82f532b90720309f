"""One place that points JAX's persistent compilation cache.

Every entry point (chip_smoke.py, bench.py, the tools, the parity
sweep) calls `enable()` before its first compile.  When
JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
set here.  Otherwise the cache goes to the fixed `<checkout>/.jax_cache`
(listed in .gitignore): the path is part of the cache key, so a fixed
directory is what lets a later run find what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Point the compile cache and return its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
