"""Persistent XLA compile cache shared by the entry points."""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache, from this file's own path (listed in .gitignore).
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Keep compiled programs across processes.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already caches there and this
    sets nothing (returns None).  Otherwise the cache goes to the fixed
    directory CACHE_DIR; the path is part of the cache key, so it never
    depends on a temporary name, a process id or the time."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
