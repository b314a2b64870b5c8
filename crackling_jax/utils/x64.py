"""Scoped 64-bit mode for JAX work that needs f64."""

from __future__ import annotations

import threading


class enable_x64:
    """try/finally ``jax_enable_x64`` toggle (restores the previous mode).

    The flag is PROCESS-GLOBAL: while held, any JAX work on other threads
    traces with x64 dtypes. The lock serializes re-entrant users, but
    callers running concurrent unrelated JAX from other threads must not
    use code that takes it."""

    _lock = threading.RLock()

    def __enter__(self):
        import jax

        self._lock.acquire()
        self.prev = bool(jax.config.jax_enable_x64)
        jax.config.update("jax_enable_x64", True)
        return self

    def __exit__(self, *exc):
        import jax

        jax.config.update("jax_enable_x64", self.prev)
        self._lock.release()
