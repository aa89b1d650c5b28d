# Diagnostic named lock.
#
# The port's own copy of aiko_services_tpu/utils/lock.py, trimmed to what
# the batching scheduler and the metrics registry use: a named lock that
# records its holder's location and thread and raises RuntimeError on
# misuse (double release, release without acquire, release by a thread
# that is not the holder).  Contention logging and the lock-order cycle
# detector stay in the JAX package until the port's host plane needs
# them.

from __future__ import annotations

import threading

__all__ = ["Lock"]


class Lock:
    """Named lock with holder diagnostics and misuse errors."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._holder: str | None = None
        self._holder_thread: threading.Thread | None = None

    def acquire(self, location: str):
        self._lock.acquire()
        self._holder = location
        self._holder_thread = threading.current_thread()

    def release(self):
        holder, holder_thread = self._holder, self._holder_thread
        if holder is None or holder_thread is None:
            raise RuntimeError(
                f"Lock {self.name}: release without acquire "
                f"(double release, or never acquired) by thread "
                f"{threading.current_thread().name!r}")
        current = threading.current_thread()
        if holder_thread is not current:
            raise RuntimeError(
                f"Lock {self.name}: released by thread {current.name!r} "
                f"but held by {holder_thread.name!r} "
                f"(acquired at {holder})")
        self._holder = None
        self._holder_thread = None
        self._lock.release()

    def __enter__(self):
        self.acquire("context-manager")
        return self

    def __exit__(self, *exc):
        self.release()
        return False
