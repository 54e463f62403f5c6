"""Persistent XLA compilation cache for the entry-point scripts.

Called by ``chip_smoke.py``, ``bench.py`` and ``experiments.main`` -- never
on library import, so importing the package changes no JAX setting.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# Fixed path inside the checkout: the cache directory is part of what a
# later run looks up, so it must not depend on a temporary name or the time.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    left alone; otherwise the cache goes to ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
