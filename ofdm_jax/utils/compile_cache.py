"""Persistent XLA compile cache for the processes this repository starts.

Called by process entry points (chip_smoke.py, bench.py, the apps), never
at package import.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# a fixed path: the cache key includes the directory, so it must not move
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> None:
    """Keep compiled programs in JAX_COMPILATION_CACHE_DIR when it is set
    (JAX reads the variable itself), else in <repo>/.jax_cache."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
