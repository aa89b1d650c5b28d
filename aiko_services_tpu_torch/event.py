# Event engine: the per-process cooperative scheduler.
#
# Capability parity with the reference event engine
# (reference: aiko_services/event.py:72-323): timer handlers (period +
# immediate), named mailboxes (FIFO, earliest-registered mailbox drains
# first), typed item queues, and flat-out handlers run every iteration.
#
# Fresh design, fixing the reference's documented defects (event.py:37-47):
#   * instantiable engine (no module-global singleton state) with a
#     module-level default instance for convenience;
#   * pluggable Clock — RealClock sleeps, VirtualClock advances manually so
#     tests are deterministic and instant;
#   * step() runs exactly one scheduler iteration (deterministic tests);
#   * thread-safe handler add/remove and puts (transport threads feed
#     mailboxes); timers keyed by handle, not handler identity;
#   * terminate() before loop() is honoured.
#
# The port's own copy of aiko_services_tpu/event.py (host code, no device
# work).

from __future__ import annotations

import heapq
import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from .observe.metrics import default_registry
from .state.wheel import TimerWheel

__all__ = [
    "Clock", "RealClock", "VirtualClock", "EventEngine", "default_engine",
    "add_timer_handler", "remove_timer_handler",
    "add_mailbox_handler", "remove_mailbox_handler", "mailbox_put",
    "add_queue_handler", "remove_queue_handler", "queue_put",
    "add_flatout_handler", "remove_flatout_handler",
    "loop", "step", "terminate", "settle_virtual",
]

_TICK = 0.01    # idle sleep when nothing is due (reference: 10ms tick)
_logger = logging.getLogger("aiko_tpu.event")


def _slow_handler_threshold() -> float:
    """AIKO_EVENT_CHECK=<seconds> (or =1 for 1 s): warn when a handler
    blocks the cooperative loop longer than this — the runtime
    counterpart of the static lint-blocking-call rule.  0 disables (the
    default; handlers doing first-call kernel builds legitimately spike)."""
    raw = os.environ.get("AIKO_EVENT_CHECK", "")
    if raw.lower() in ("", "0", "false", "no", "off"):
        return 0.0
    try:
        return float(raw)
    except ValueError:
        return 1.0


SLOW_HANDLER_SECONDS = _slow_handler_threshold()

# Event-loop health on the process-wide metrics registry:
# the runtime counterpart of the AIKO_EVENT_CHECK watchdog — handler
# latency is ALWAYS histogrammed (cheap: two perf_counter reads + a
# short bucket scan per handler), the slow-handler counter feeds the
# per-rung budget calibration the watchdog's log line can't, and the
# mailbox-depth gauge exposes the backlog each scheduler step drains.
_registry = default_registry()
_HANDLER_SECONDS = _registry.histogram(
    "event_handler_seconds",
    "wall time per event-engine handler invocation")
_SLOW_HANDLERS = _registry.counter(
    "event_slow_handlers_total",
    "handlers that blocked the loop past AIKO_EVENT_CHECK")
_MAILBOX_DEPTH = _registry.gauge(
    "event_mailbox_depth",
    "items pending across all mailboxes at scheduler-step start")


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic clock: sleep() advances virtual time instantly."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._now += seconds

    def advance(self, seconds: float) -> None:
        self._now += seconds


@dataclass(order=True)
class _Timer:
    due: float
    seq: int
    handler: Callable = field(compare=False)
    period: float = field(compare=False, default=0.0)
    cancelled: bool = field(compare=False, default=False)


class _Mailbox:
    __slots__ = ("name", "handler", "items", "high_water")

    def __init__(self, name, handler):
        self.name = name
        self.handler = handler          # handler(name, item, time)
        self.items: deque = deque()
        self.high_water = 0


class EventEngine:
    def __init__(self, clock: Clock | None = None):
        self.clock = clock or RealClock()
        self._lock = threading.RLock()
        self._seq = itertools.count()
        # ONESHOT timers (leases, hop/handshake timeouts — the
        # session-cardinality population) ride the hashed timer wheel:
        # O(1) schedule/cancel/advance.  The heap remains
        # only for the sparse PERIODIC handlers (metrics publishers,
        # admission drains, snapshot ticks — tens per process).
        self._wheel = TimerWheel(self.clock.now(), tick=_TICK)
        # handles cancelled while their expiry batch is in flight this
        # step (the wheel has already surrendered them); cleared per
        # step, so the set stays bounded by one batch
        self._step_cancelled: set[int] = set()
        self._timers: list[_Timer] = []          # heap: periodic only
        self._timer_handles: dict[int, _Timer] = {}
        self._mailboxes: dict[str, _Mailbox] = {}
        self._queues: dict[str, _Mailbox] = {}
        self._flatout: list[Callable] = []
        self._running = False
        self._terminated = False
        self._wake = threading.Event()

    # -- handler bookkeeping ----------------------------------------------
    def live_timer_handlers(self) -> list:
        """Callables of every LIVE timer — periodic (heap) and oneshot
        (wheel).  The leak-audit surface: a cancelled timer never
        appears here, so 'no Lease-owned handler left' is exactly 'no
        lease can ever fire again' (the chaos soak and the lease
        lifecycle tests assert over this instead of poking the stores)."""
        with self._lock:
            handlers = [t.handler for t in self._timer_handles.values()
                        if not t.cancelled]
            handlers.extend(e.payload for e in self._wheel.entries())
            return handlers

    def _handler_count(self) -> int:
        with self._lock:
            return (len(self._timer_handles) + len(self._wheel)
                    + len(self._mailboxes)
                    + len(self._queues) + len(self._flatout))

    # -- timers -----------------------------------------------------------
    def add_timer_handler(self, handler, period: float,
                          immediate: bool = False) -> int:
        """Schedule handler() every `period` seconds; returns a handle."""
        with self._lock:
            seq = next(self._seq)
            due = self.clock.now() if immediate else self.clock.now() + period
            timer = _Timer(due, seq, handler, period)
            heapq.heappush(self._timers, timer)
            self._timer_handles[seq] = timer
            self._wake.set()
            return seq

    def add_oneshot_handler(self, handler, delay: float) -> int:
        """Schedule handler() once after `delay` seconds.  Oneshots are
        wheel-backed: schedule and cancel are O(1) however many are
        outstanding — Lease and every hop timeout ride this."""
        with self._lock:
            seq = next(self._seq)
            self._wheel.schedule(self.clock.now() + delay, handler,
                                 handle=seq)
            self._wake.set()
            return seq

    def remove_timer_handler(self, handle_or_handler) -> None:
        with self._lock:
            if isinstance(handle_or_handler, int):
                timer = self._timer_handles.pop(handle_or_handler, None)
                if timer:
                    timer.cancelled = True
                elif not self._wheel.cancel(handle_or_handler):
                    # maybe in the currently-firing batch: suppress it
                    # there (heap parity: cancel before fire always
                    # sticks, even from a handler in the same step)
                    self._step_cancelled.add(handle_or_handler)
                return
            # compatibility: remove all timers with this handler
            # function — a LINEAR scan over both stores, kept only for
            # parity with the reference API.  Per-frame/per-session
            # code must cancel by handle (lint-linear-timer polices
            # this).
            for seq, timer in list(self._timer_handles.items()):
                if timer.handler == handle_or_handler:
                    timer.cancelled = True
                    del self._timer_handles[seq]
            for entry in self._wheel.entries():
                if entry.payload == handle_or_handler:
                    self._wheel.cancel(entry.handle)

    def reset_timer(self, handle: int) -> None:
        """Restart a periodic timer's countdown from now."""
        with self._lock:
            timer = self._timer_handles.pop(handle, None)
            if not timer:
                return
            timer.cancelled = True
            new = _Timer(self.clock.now() + timer.period, handle,
                         timer.handler, timer.period)
            heapq.heappush(self._timers, new)
            self._timer_handles[handle] = new

    # -- mailboxes ---------------------------------------------------------
    def add_mailbox_handler(self, handler, name: str) -> None:
        """handler(name, item, put_time); earliest-registered drains first."""
        with self._lock:
            if name in self._mailboxes:
                raise ValueError(f"mailbox exists: {name}")
            self._mailboxes[name] = _Mailbox(name, handler)

    def remove_mailbox_handler(self, name: str) -> None:
        with self._lock:
            self._mailboxes.pop(name, None)

    def mailbox_put(self, name: str, item) -> None:
        with self._lock:
            mailbox = self._mailboxes.get(name)
            if mailbox is None:
                return
            mailbox.items.append((item, self.clock.now()))
            mailbox.high_water = max(mailbox.high_water, len(mailbox.items))
            self._wake.set()

    # -- queues ------------------------------------------------------------
    def add_queue_handler(self, handler, name: str) -> None:
        with self._lock:
            if name in self._queues:
                raise ValueError(f"queue exists: {name}")
            self._queues[name] = _Mailbox(name, handler)

    def remove_queue_handler(self, name: str) -> None:
        with self._lock:
            self._queues.pop(name, None)

    def queue_put(self, name: str, item) -> None:
        with self._lock:
            queue = self._queues.get(name)
            if queue is None:
                return
            queue.items.append((item, self.clock.now()))
            self._wake.set()

    # -- flatout -----------------------------------------------------------
    def add_flatout_handler(self, handler) -> None:
        with self._lock:
            self._flatout.append(handler)

    def remove_flatout_handler(self, handler) -> None:
        with self._lock:
            if handler in self._flatout:
                self._flatout.remove(handler)

    # -- scheduler ---------------------------------------------------------
    @staticmethod
    def _guard(handler, *args) -> None:
        """Handler faults must never kill the scheduler: any remote peer can
        trigger a handler exception with one malformed message.  With
        AIKO_EVENT_CHECK set, handlers that BLOCK the loop past the
        threshold are reported too (wall time: the loop is stalled for
        real regardless of which clock the engine schedules by)."""
        started = time.perf_counter()
        try:
            handler(*args)
        except Exception:
            _logger.exception("event handler %r raised",
                              getattr(handler, "__qualname__", handler))
        elapsed = time.perf_counter() - started
        _HANDLER_SECONDS.observe(elapsed)
        if SLOW_HANDLER_SECONDS and elapsed > SLOW_HANDLER_SECONDS:
            _SLOW_HANDLERS.inc()
            _logger.warning(
                "event handler %r blocked the loop for %.3fs "
                "(threshold %.3fs; every pipeline in this process "
                "stalled meanwhile)",
                getattr(handler, "__qualname__", handler), elapsed,
                SLOW_HANDLER_SECONDS)

    def step(self) -> bool:
        """Run one scheduler iteration.  Returns True if any work was done."""
        worked = False
        now = self.clock.now()

        # due ONESHOTS off the wheel first (tick order; batch collected
        # under the lock, delivered outside it).  A handler in the
        # batch may cancel a LATER entry of the same batch — the wheel
        # has already surrendered those, so the cancel lands in
        # _step_cancelled and is honoured here (heap parity: a timer
        # never fires after its cancel).
        with self._lock:
            due_oneshots = self._wheel.advance(now)
            self._step_cancelled.clear()
        for entry in due_oneshots:
            with self._lock:
                if entry.handle in self._step_cancelled:
                    continue
            self._guard(entry.payload)
            worked = True

        # due PERIODIC timers (all that are due, in order)
        while True:
            with self._lock:
                if not self._timers or self._timers[0].due > now:
                    break
                timer = heapq.heappop(self._timers)
                if timer.cancelled:
                    continue
                if timer.period > 0:
                    renewed = _Timer(timer.due + timer.period, timer.seq,
                                     timer.handler, timer.period)
                    heapq.heappush(self._timers, renewed)
                    self._timer_handles[timer.seq] = renewed
                else:
                    self._timer_handles.pop(timer.seq, None)
            self._guard(timer.handler)
            worked = True

        # one item per queue
        with self._lock:
            queues = list(self._queues.values())
        for queue in queues:
            try:
                item, put_time = queue.items.popleft()
            except IndexError:
                continue
            self._guard(queue.handler, queue.name, item, put_time)
            worked = True

        # Drain mailboxes in registration order; re-check the first mailbox
        # after every item so it preempts later ones (control-before-data).
        # Budget = items present at drain start: a handler that posts back
        # into a mailbox cannot livelock the step (its items wait for the
        # next iteration once the budget is spent).
        with self._lock:
            budget = sum(len(m.items) for m in self._mailboxes.values())
        _MAILBOX_DEPTH.set(budget)
        while budget > 0:
            with self._lock:
                target = None
                for mailbox in self._mailboxes.values():
                    if mailbox.items:
                        target = mailbox
                        break
                if target is None:
                    break
                item, put_time = target.items.popleft()
            self._guard(target.handler, target.name, item, put_time)
            worked = True
            budget -= 1

        with self._lock:
            flatout = list(self._flatout)
        for handler in flatout:
            self._guard(handler)
            worked = True
        return worked

    def _next_due(self) -> float | None:
        with self._lock:
            while self._timers and self._timers[0].cancelled:
                heapq.heappop(self._timers)
            heap_due = self._timers[0].due if self._timers else None
            wheel_due = self._wheel.next_due()
        if heap_due is None:
            return wheel_due
        if wheel_due is None:
            return heap_due
        return min(heap_due, wheel_due)

    def loop(self, loop_when_no_handlers: bool = False) -> None:
        self._running = True
        try:
            while not self._terminated:
                if self._handler_count() == 0 and not loop_when_no_handlers:
                    break
                worked = self.step()
                if worked:
                    continue
                due = self._next_due()
                now = self.clock.now()
                delay = _TICK if due is None else max(0.0, min(due - now,
                                                               _TICK))
                if isinstance(self.clock, RealClock):
                    # sleep, but wake instantly on put/terminate
                    self._wake.clear()
                    self._wake.wait(delay if delay > 0 else _TICK)
                else:
                    self.clock.sleep(delay if delay > 0 else _TICK)
        finally:
            self._running = False
            self._terminated = False

    def run_until(self, predicate, timeout: float = 5.0) -> bool:
        """Drive the engine until predicate() is True.  For tests and
        synchronous bootstrap; works with both real and virtual clocks."""
        deadline = self.clock.now() + timeout
        while not predicate():
            if self.clock.now() >= deadline:
                return False
            if not self.step():
                due = self._next_due()
                now = self.clock.now()
                delay = _TICK if due is None else max(0.0,
                                                      min(due - now, _TICK))
                self.clock.sleep(delay if delay > 0 else _TICK)
        return True

    def terminate(self) -> None:
        self._terminated = True
        self._wake.set()


default_engine = EventEngine()


def add_timer_handler(handler, period, immediate=False):
    return default_engine.add_timer_handler(handler, period, immediate)


def remove_timer_handler(handle_or_handler):
    default_engine.remove_timer_handler(handle_or_handler)


def add_mailbox_handler(handler, name):
    default_engine.add_mailbox_handler(handler, name)


def remove_mailbox_handler(name):
    default_engine.remove_mailbox_handler(name)


def mailbox_put(name, item):
    default_engine.mailbox_put(name, item)


def add_queue_handler(handler, name):
    default_engine.add_queue_handler(handler, name)


def remove_queue_handler(name):
    default_engine.remove_queue_handler(name)


def queue_put(name, item):
    default_engine.queue_put(name, item)


def add_flatout_handler(handler):
    default_engine.add_flatout_handler(handler)


def remove_flatout_handler(handler):
    default_engine.remove_flatout_handler(handler)


def settle_virtual(engine, seconds, tick=0.05):
    """Advance a VirtualClock engine by `seconds`, stepping the engine
    dry each tick — the one canonical drive loop for timed
    multi-runtime scenarios (tests and the chaos soak runner)."""
    for _ in range(int(seconds / tick)):
        while engine.step():
            pass
        engine.clock.advance(tick)
    while engine.step():
        pass


def loop(loop_when_no_handlers=False):
    default_engine.loop(loop_when_no_handlers)


def step():
    return default_engine.step()


def terminate():
    default_engine.terminate()
