"""Persistent XLA compilation cache placement, shared by every entry point.

The 1M-particle scenes take minutes to compile cold; a persistent cache
lets a second process (or a second run) skip that. The cache directory is
part of the cache's key, so it must not move between runs:

  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this
    module sets nothing;
  * otherwise: the fixed ``<checkout>/.jax_cache`` (listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    CHECKOUT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
