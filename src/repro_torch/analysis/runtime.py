"""Opt-in runtime sanitizer: lock-held assertions for shared state.

Port of the part of ``repro/analysis/runtime.py`` that ``net/fabric.py``
and ``pipeline/`` use: the lock-held assertion and the single-owner
thread assertion. Everything here is off by default (one boolean on the
hot path) and is enabled per object (``Fabric(sanitize=True)``,
``CacheBuilder(sanitize=True)``) or process-wide with
``REPRO_SANITIZE=1``.
"""
from __future__ import annotations

import os
import threading

SANITIZE_ENV = "REPRO_SANITIZE"


def sanitize_enabled(override: bool | None = None) -> bool:
    """Resolve a sanitize flag: explicit override, else ``REPRO_SANITIZE``
    (truthy: anything but empty/``0``/``false``/``no``/``off``)."""
    if override is not None:
        return bool(override)
    raw = os.environ.get(SANITIZE_ENV, "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


class SanitizerError(AssertionError):
    """A runtime invariant the sanitizer enforces was violated."""


def assert_lock_held(lock, what: str) -> None:
    """Raise :class:`SanitizerError` unless the calling thread holds
    ``lock`` (RLock owner check; a plain Lock degrades to a locked
    check)."""
    owned = lock._is_owned() if hasattr(lock, "_is_owned") else lock.locked()
    if not owned:
        raise SanitizerError(
            f"{what}: called without holding its lock — shared state "
            "would be mutated racily (lock-discipline invariant)"
        )


class ThreadAffinity:
    """Asserts an API is only ever driven from one (the first) thread.

    The pipeline's contract is single-producer/single-consumer with every
    consumer-side call on one thread; breaking it does not deadlock, it
    silently corrupts the measured aggregates. The first :meth:`check`
    binds the owner; a later call from any other thread raises."""

    def __init__(self, role: str):
        self.role = role
        self._ident: int | None = None
        self._name = ""

    def check(self, what: str) -> None:
        me = threading.current_thread()
        if self._ident is None:
            self._ident, self._name = me.ident, me.name
        elif me.ident != self._ident:
            raise SanitizerError(
                f"{what}: called from thread {me.name!r} but the "
                f"{self.role} role is owned by thread {self._name!r} — "
                "single-consumer contract violated"
            )
