"""Where JAX keeps its persistent compilation cache.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself. Where that variable is set,
nothing is set here. Otherwise the cache lives at one fixed path inside the
checkout, `<checkout>/.jax_cache` (git-ignored): the path is part of the
cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Configure the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
