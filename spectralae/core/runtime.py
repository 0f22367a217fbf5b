"""Runtime setup: JAX's persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_cache_enabled = False
_cache_path: Path | None = None


def enable_compilation_cache(path: str | os.PathLike | None = None) -> None:
    """Enable JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and no other directory is set in code (``path`` is ignored).
    Otherwise the cache lives at ``path``, or at the fixed in-checkout
    ``.jax_cache`` (a fixed path, because the path is part of the cache
    key).  Safe to call multiple times.
    """
    global _cache_enabled, _cache_path
    if _cache_enabled:
        return
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        _cache_path = Path(env)
    else:
        _cache_path = Path(path) if path is not None else DEFAULT_CACHE_DIR
        _cache_path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(_cache_path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _cache_enabled = True


def cache_dir() -> Path:
    """The compile-cache directory in use, or the one
    :func:`enable_compilation_cache` would choose."""
    if _cache_path is not None:
        return _cache_path
    env = os.environ.get(ENV_CACHE_DIR)
    return Path(env) if env else DEFAULT_CACHE_DIR
