"""Persistent XLA compilation cache for the entry points.

Compiling the solver step for the card takes tens of seconds, and a run
that finds its programs in the cache skips that.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this sets
nothing.  Otherwise the cache lives at one fixed path in the checkout
(``.jax_cache/``, ignored by git): the directory is part of what a later
run must find again, so it is never built from a temporary name, a process
id or the time."""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent cache at :data:`CACHE_DIR` unless the
    environment names one.  Returns the directory this call set, or None
    when the environment's setting stands."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
