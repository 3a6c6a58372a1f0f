"""Persistent XLA compilation cache.

The reference framework pays its (small) torch start-up cost on every
process start; this framework's costs are front-loaded into XLA compiles
of the jitted train steps instead.  JAX can serialize compiled
executables to disk and reload them on the next process start, turning
the second and later runs of every benchmark / experiment config into
loads.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when the environment
sets it (JAX reads that variable itself, and this helper then points
nowhere else); otherwise ``<repo>/.jax_cache``, a fixed path so that
later processes hit it.

Usage::

    from pspde.utils import enable_compilation_cache
    enable_compilation_cache()

Call BEFORE the first jit compilation.  Safe to call on any backend:
if the backend's executables are not serializable, JAX logs a warning
per compile and runs uncached — behaviour is unchanged.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache(path: str | None = None,
                             min_compile_seconds: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at a directory (created if
    missing) and return it.  ``JAX_COMPILATION_CACHE_DIR``, when set,
    takes precedence over ``path``; without either the cache goes to
    ``<repo>/.jax_cache``.  Executables whose compile took >=
    ``min_compile_seconds`` are written; later processes with identical
    jaxpr/config/shape hash deserialize instead of recompiling.
    Idempotent (jax.config.update is)."""
    path = os.path.abspath(os.environ.get(ENV_VAR) or path or DEFAULT_DIR)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_seconds))
    # cache every entry regardless of the backend's own size heuristics
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
