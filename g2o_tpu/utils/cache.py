"""Where the program keeps what it builds at run time.

Everything lives under one fixed directory inside the checkout
(``<checkout>/.cache``, listed in ``.gitignore``): the native library and,
unless ``JAX_COMPILATION_CACHE_DIR`` names another place, JAX's persistent
compilation cache.  The directory never depends on a temporary name, a
process id or the time, because the cache's path is part of its key: a
directory that moves never hits."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ROOT = os.path.join(CHECKOUT, ".cache")
COMPILE_CACHE_DIR = os.path.join(CACHE_ROOT, "jax")

_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to
    :data:`COMPILE_CACHE_DIR`, and only programs that took at least a
    second to compile are kept."""
    path = os.environ.get(_ENV)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return COMPILE_CACHE_DIR
