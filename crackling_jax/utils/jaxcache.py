"""Persistent XLA compilation cache.

Compiled engine programs persist across processes, so only the first run
of a given (program, shape) pays the compiler. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no other
directory is set here; otherwise the cache lives at a fixed path inside
the checkout, ``.cache/jax`` (the path is part of the cache's key, so it
must not move between runs). Every engine module and the CLIs call this
before building jitted functions; it is idempotent.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".cache" / "jax"

_DONE = False


def enable_persistent_cache() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
