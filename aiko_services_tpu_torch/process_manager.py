# ProcessManager: spawn and supervise OS child processes.
#
# The port's own copy of aiko_services_tpu/process_manager.py: a
# Popen-based child table keyed by caller id, periodic child polling on
# the EventEngine (no dedicated thread, so tests drive it
# deterministically), an exit-handler callback with (id, pid,
# return_code), a `spawn_python` helper that launches module targets with
# the current interpreter, and an optional RestartPolicy per spawn:
# exponential backoff + seeded jitter between respawns and a crash-loop
# detector (too many restarts inside a sliding window gives up instead of
# thrashing), all timed on the engine clock.

from __future__ import annotations

import random
import shlex
import subprocess
import sys
from collections import deque
from dataclasses import dataclass

from .utils import get_logger, jittered_backoff

__all__ = ["ProcessManager", "RestartPolicy", "RestartWindow"]

_POLL_PERIOD = 0.2      # seconds


@dataclass(frozen=True)
class RestartPolicy:
    """Supervision policy for a spawned child.

    max_restarts restarts inside `window` seconds is a crash loop: the
    supervisor stops respawning and reports through crash_loop_handler /
    process_exit_handler instead of thrashing the host.  Backoff doubles
    per consecutive restart inside the window and carries jitter so a
    fleet of supervisors does not stampede — seed=None (default) spreads
    for real; pass a seed for reproducible tests."""
    max_restarts: int = 3
    window: float = 60.0            # seconds, crash-loop detection span
    backoff: float = 0.5            # first respawn delay
    backoff_max: float = 30.0
    jitter: float = 0.25            # fraction of the delay
    restart_on_success: bool = False    # also respawn rc == 0 exits
    seed: int | None = None         # None = urandom (deterministic opt-in)

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Jittered exponential backoff for the attempt-th restart."""
        return jittered_backoff(self.backoff, attempt, self.backoff_max,
                                self.jitter, rng)


class RestartWindow:
    """Sliding-window crash-loop accounting, shared by ProcessManager
    (per-child) and LifeCycleManager (per-fleet): record() a death and
    get back the respawn delay, or None once the window budget is spent
    (crash loop — stop respawning)."""

    def __init__(self, policy: RestartPolicy):
        self.policy = policy
        self.events: deque[float] = deque()     # engine-clock death times
        self.rng = random.Random(policy.seed)

    def record(self, now: float) -> float | None:
        self.events.append(now)
        while self.events and now - self.events[0] > self.policy.window:
            self.events.popleft()
        if len(self.events) > self.policy.max_restarts:
            return None
        return self.policy.delay_for(len(self.events), self.rng)


class _Supervised:
    """Restart bookkeeping for one managed id."""
    __slots__ = ("argv", "popen_kwargs", "policy", "window",
                 "pending_timer", "crash_looping")

    def __init__(self, argv, popen_kwargs, policy: RestartPolicy):
        self.argv = argv
        self.popen_kwargs = popen_kwargs
        self.policy = policy
        self.window = RestartWindow(policy)
        self.pending_timer = None
        self.crash_looping = False


class ProcessManager:
    def __init__(self, engine, process_exit_handler=None,
                 poll_period: float = _POLL_PERIOD,
                 crash_loop_handler=None):
        self.engine = engine
        self.process_exit_handler = process_exit_handler
        # crash_loop_handler(id, exit_times) when supervision gives up
        self.crash_loop_handler = crash_loop_handler
        self.logger = get_logger("process_manager")
        self.processes: dict[str, subprocess.Popen] = {}
        self._supervised: dict[str, _Supervised] = {}
        self._timer = engine.add_timer_handler(self._poll, poll_period)

    def spawn(self, id, command, arguments=(),
              restart: RestartPolicy | None = None, **popen_kwargs) -> int:
        """Launch `command arguments...`; returns the OS pid.  With a
        RestartPolicy the child is supervised: exits respawn it under
        backoff until the crash-loop budget is spent."""
        id = str(id)
        if id in self.processes:
            raise ValueError(f"process id exists: {id}")
        stale = self._supervised.pop(id, None)
        if stale is not None and stale.pending_timer is not None:
            # a previous incarnation awaiting respawn: this spawn
            # supersedes it — its timer must not resurrect the old argv
            self.engine.remove_timer_handler(stale.pending_timer)
            stale.pending_timer = None
        if isinstance(command, str):
            argv = shlex.split(command) + [str(a) for a in arguments]
        else:
            argv = list(command) + [str(a) for a in arguments]
        pid = self._launch(id, argv, popen_kwargs)
        if restart is not None:    # only supervise a launch that succeeded
            self._supervised[id] = _Supervised(argv, popen_kwargs, restart)
        return pid

    def _launch(self, id: str, argv, popen_kwargs) -> int:
        process = subprocess.Popen(argv, **popen_kwargs)
        self.processes[id] = process
        self.logger.info("spawned %s: pid %s: %s", id, process.pid,
                         " ".join(argv))
        return process.pid

    def spawn_python(self, id, module: str, arguments=(), **popen_kwargs):
        """Launch `python -m module args...` with this interpreter."""
        return self.spawn(id, [sys.executable, "-m", module], arguments,
                          **popen_kwargs)

    def delete(self, id, kill: bool = True, timeout: float = 5.0) -> None:
        id = str(id)
        supervised = self._supervised.pop(id, None)
        if supervised is not None and supervised.pending_timer is not None:
            self.engine.remove_timer_handler(supervised.pending_timer)
            supervised.pending_timer = None
        process = self.processes.pop(id, None)
        if process is None:
            return
        if kill and process.poll() is None:
            process.terminate()
            try:
                process.wait(timeout)
            except subprocess.TimeoutExpired:
                process.kill()
                process.wait()

    def process_ids(self):
        return list(self.processes)

    def __contains__(self, id):
        return str(id) in self.processes

    def restart_state(self, id) -> dict:
        """Supervision diagnostics for an id: restart count inside the
        window, crash-loop flag, respawn pending."""
        supervised = self._supervised.get(str(id))
        if supervised is None:
            return {}
        return {"recent_exits": len(supervised.window.events),
                "crash_looping": supervised.crash_looping,
                "respawn_pending": supervised.pending_timer is not None}

    def _poll(self) -> None:
        for id, process in list(self.processes.items()):
            return_code = process.poll()
            if return_code is None:
                continue
            del self.processes[id]
            self.logger.info("process %s (pid %s) exited: %s", id,
                             process.pid, return_code)
            restarting = self._maybe_restart(id, return_code)
            if self.process_exit_handler and not restarting:
                try:
                    self.process_exit_handler(id, process.pid, return_code)
                except Exception:
                    self.logger.exception("exit handler raised for %s", id)

    def _maybe_restart(self, id: str, return_code) -> bool:
        """Schedule a supervised respawn; True when one is pending (the
        exit is then an internal event, not a terminal one)."""
        supervised = self._supervised.get(id)
        if supervised is None or supervised.crash_looping:
            return False
        policy = supervised.policy
        if return_code == 0 and not policy.restart_on_success:
            self._supervised.pop(id, None)      # clean exit: done
            return False
        delay = supervised.window.record(self.engine.clock.now())
        if delay is None:
            supervised.crash_looping = True
            self.logger.error(
                "process %s: crash loop (%d exits in %.1fs); giving up",
                id, len(supervised.window.events), policy.window)
            if self.crash_loop_handler:
                try:
                    self.crash_loop_handler(
                        id, list(supervised.window.events))
                except Exception:
                    self.logger.exception("crash-loop handler raised "
                                          "for %s", id)
            return False
        self.logger.warning("process %s exited %s; restart %d/%d in %.2fs",
                            id, return_code,
                            len(supervised.window.events),
                            policy.max_restarts, delay)
        supervised.pending_timer = self.engine.add_oneshot_handler(
            lambda: self._respawn(id), delay)
        return True

    def _respawn(self, id: str) -> None:
        supervised = self._supervised.get(id)
        if supervised is None:
            return
        supervised.pending_timer = None
        if id in self.processes:        # re-spawned by hand meanwhile
            return
        try:
            self._launch(id, supervised.argv, supervised.popen_kwargs)
        except Exception as exc:
            # a failed launch is an exit: re-enter the restart window so
            # the backoff/crash-loop budget governs it, and surface the
            # terminal failure instead of silently ending supervision
            self.logger.exception("respawn of %s failed", id)
            restarting = self._maybe_restart(id, f"spawn failed: {exc!r}")
            if self.process_exit_handler and not restarting:
                try:
                    self.process_exit_handler(id, None, exc)
                except Exception:
                    self.logger.exception("exit handler raised for %s", id)

    def terminate(self, kill_children: bool = True) -> None:
        self.engine.remove_timer_handler(self._timer)
        for id in list(self.processes):
            self.delete(id, kill=kill_children)
        for supervised in self._supervised.values():
            if supervised.pending_timer is not None:
                self.engine.remove_timer_handler(supervised.pending_timer)
                supervised.pending_timer = None
        self._supervised.clear()
