# Diagnostic named lock and the runtime lock-order race detector.
#
# The port's own copy of aiko_services_tpu/utils/lock.py.  The lock
# records its holder's location string and thread, warns on contention,
# and raises RuntimeError on misuse (double release, release without
# acquire, release by a thread that is not the holder).
#
# Opt-in lock-order checking (AIKO_LOCK_CHECK=1 at import, or
# enable_lock_check()): every nested acquisition records an edge
# lock_held -> lock_acquired in a process-global order graph, keyed by
# lock name.  A new edge that closes a cycle is a potential ABBA
# deadlock, reported with both acquisition stacks (where each direction
# was first taken) through lock_check_report(), and logged.  The
# detector is conservative: it flags inconsistent ordering even when
# seen from one thread, because the same two code paths on two threads
# will deadlock.  A re-entrant acquire of the same lock instance (a
# certain self-deadlock for this non-reentrant lock) raises at once
# instead of hanging.  The port's checker is its own: the JAX package's
# report does not see the port's locks, nor the port's the JAX package's.
#
# Overhead when disabled: one module-global boolean test per acquire and
# release.

from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from dataclasses import dataclass

__all__ = [
    "Lock", "LockOrderViolation", "enable_lock_check",
    "lock_check_enabled", "lock_check_report", "lock_check_reset",
]

_logger = logging.getLogger("aiko_tpu_torch.lock")


def _env_enabled() -> bool:
    return os.environ.get("AIKO_LOCK_CHECK", "").lower() \
        not in ("", "0", "false", "no", "off")


_enabled = _env_enabled()


def lock_check_enabled() -> bool:
    return _enabled


def enable_lock_check(on: bool = True) -> None:
    """Turn the lock-order detector on/off at runtime (the env var
    AIKO_LOCK_CHECK sets the initial state at import)."""
    global _enabled
    _enabled = bool(on)


@dataclass(frozen=True)
class LockOrderViolation:
    """A potential deadlock: both acquisition orders were observed."""
    cycle: tuple            # lock names, e.g. ("B", "A", "B")
    this_stack: str         # where the cycle-closing order was taken
    prior_stack: str        # where the opposite order was first taken

    def __str__(self):
        chain = " -> ".join(self.cycle)
        return (f"potential deadlock: lock order cycle {chain}\n"
                f"--- this acquisition ---\n{self.this_stack}"
                f"--- prior (opposite) acquisition ---\n"
                f"{self.prior_stack}")


class _OrderChecker:
    """Process-global acquisition-order graph over diagnostic locks."""

    def __init__(self):
        # guards the checker's own graph; deliberately a raw lock — the
        # checker cannot instrument itself
        self._lock = threading.Lock()   # graft: disable=lint-raw-lock
        self._edges: dict[tuple, str] = {}      # (a, b) -> first stack
        self._succ: dict[str, set] = {}
        self._violations: list[LockOrderViolation] = []
        self._local = threading.local()

    # -- per-thread held stack --------------------------------------------
    def held(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- graph -------------------------------------------------------------
    def _path(self, src: str, dst: str):
        """DFS path src -> dst through recorded edges, or None."""
        visited = {src}
        trail = [(src, [src])]
        while trail:
            name, path = trail.pop()
            if name == dst:
                return path
            for successor in self._succ.get(name, ()):
                if successor not in visited:
                    visited.add(successor)
                    trail.append((successor, path + [successor]))
        return None

    def before_acquire(self, lock: "Lock") -> None:
        for held_id, _name in self.held():
            if held_id == id(lock):
                raise RuntimeError(
                    f"Lock {lock.name}: re-entrant acquire by thread "
                    f"{threading.current_thread().name!r} would "
                    f"self-deadlock (held since {lock._holder})")

    def after_acquire(self, lock: "Lock") -> None:
        held = self.held()
        if held:
            stack_text = None       # built only when a NEW edge appears:
            with self._lock:        # steady state stays a dict lookup
                for _held_id, held_name in held:
                    if held_name == lock.name:
                        continue
                    edge = (held_name, lock.name)
                    if edge in self._edges:
                        continue
                    if stack_text is None:
                        stack_text = "".join(
                            traceback.format_stack(limit=16)[:-2])
                    # does the REVERSE order already exist?  check before
                    # inserting so the cycle path excludes this edge
                    path = self._path(lock.name, held_name)
                    self._edges[edge] = stack_text
                    self._succ.setdefault(held_name, set()).add(lock.name)
                    if path:
                        prior = self._edges.get(tuple(path[:2]), "")
                        violation = LockOrderViolation(
                            cycle=tuple(path + [lock.name]),
                            this_stack=stack_text, prior_stack=prior)
                        self._violations.append(violation)
                        _logger.error("%s", violation)
        held.append((id(lock), lock.name))

    def after_release(self, lock: "Lock") -> None:
        held = self.held()
        for index in range(len(held) - 1, -1, -1):
            if held[index][0] == id(lock):
                del held[index]
                return

    # -- reporting ---------------------------------------------------------
    def report(self) -> list:
        with self._lock:
            return list(self._violations)

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._succ.clear()
            self._violations.clear()


_checker = _OrderChecker()


def lock_check_report() -> list:
    """All LockOrderViolations observed since the last reset."""
    return _checker.report()


def lock_check_reset() -> None:
    _checker.reset()


class Lock:
    """Named lock with holder diagnostics and misuse errors.

    acquire(location) records WHERE and on WHICH THREAD the lock was
    taken; contention logs a warning naming both.  release() raises
    RuntimeError on double release, release without acquire, and release
    by a non-holder thread.  With AIKO_LOCK_CHECK=1 every acquisition
    also feeds the global lock-order cycle detector above."""

    def __init__(self, name: str, logger=None):
        self.name = name
        self._logger = logger
        # the wrapped primitive itself (this IS the diagnostic wrapper)
        self._lock = threading.Lock()   # graft: disable=lint-raw-lock
        self._holder: str | None = None
        self._holder_thread: threading.Thread | None = None
        self._acquired_at = 0.0
        self.max_hold = 0.0             # longest observed hold (seconds)

    def acquire(self, location: str):
        if _enabled:
            _checker.before_acquire(self)
        if self._holder is not None and self._logger:
            holder_thread = self._holder_thread
            self._logger.warning(
                "Lock %s: %s waiting on holder %s [thread %s]",
                self.name, location, self._holder,
                holder_thread.name if holder_thread else "?")
        self._lock.acquire()
        self._holder = location
        self._holder_thread = threading.current_thread()
        self._acquired_at = time.monotonic()
        if _enabled:
            _checker.after_acquire(self)

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
        held_for = time.monotonic() - self._acquired_at
        if held_for > self.max_hold:
            self.max_hold = held_for
        self._holder = None
        self._holder_thread = None
        if _enabled:
            _checker.after_release(self)
        self._lock.release()

    def in_use(self) -> bool:
        return self._holder is not None

    def holder(self):
        """(location, thread name) of the current holder, or None."""
        holder, holder_thread = self._holder, self._holder_thread
        if holder is None:
            return None
        return holder, holder_thread.name if holder_thread else "?"

    def __enter__(self):
        self.acquire("context-manager")
        return self

    def __exit__(self, *exc):
        self.release()
        return False
