"""Persistent XLA compilation cache.

The reference JIT-builds its OpenCL kernel from source on every process
start (``src/FftMethod.cpp:344-345``); the equivalent of shipping prebuilt
binaries here is JAX's persistent compilation cache — the first process
compiles, every later one loads the executable from disk.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing is set
  in code, so the deployment decides;
- unset: one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``).  The path is part of what a later process must
  find again, so it is never built from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
import pathlib

#: the in-checkout default (``<repo>/.jax_cache``)
DEFAULT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Enable the on-disk jit cache (idempotent). Returns the directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
