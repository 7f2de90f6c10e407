"""JAX's persistent compilation cache, kept at one fixed place.

The cache key includes the cache's path, so a directory that moves never
hits.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here; otherwise the cache lives in ``.jax_cache/`` at the
root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  Call before the first compilation."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
