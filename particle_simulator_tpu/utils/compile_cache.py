"""Persistent JAX compilation cache for the engine's entry points.

The reference pays zero compile latency (nvcc compiles ahead of time,
cuda_simulator/Makefile:9-17); XLA compiles each frame program at its first
dispatch instead. JAX's persistent compilation cache makes that a
once-per-checkout cost: serialized executables land in a directory keyed by
program and compiler fingerprint, and later runs deserialize them.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself, and this
  module sets no other directory;
- otherwise ``.jax_cache/`` at the root of the checkout (git-ignored). The
  path is fixed because it is part of the cache key: a directory that moves
  between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses once ``enable_compilation_cache`` ran."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)


def enable_compilation_cache() -> str:
    """Turn the persistent cache on (see the module docstring for where).
    Returns the active cache directory."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        CHECKOUT_CACHE.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return cache_dir()
