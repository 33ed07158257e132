"""Platform bring-up helpers: compilation caching, device selection."""

from __future__ import annotations

import os
from pathlib import Path

#: Fixed in-checkout cache location (listed in .gitignore). The path is part
#: of JAX's cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache.

    With the cache, every identically-shaped run after the first skips the
    tracker-step compile. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    already reads it and no other directory is set here. Safe to call
    multiple times; call before the first jit compilation.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def force_cpu() -> None:
    """Pin JAX to the CPU backend (tests, CI, hardware-free hosts).

    Must run before any JAX backend initialization; the explicit config
    update also holds where an accelerator plugin registers itself.
    """
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
