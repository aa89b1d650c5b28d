# Distributed tracing: trace contexts with deadlines, and a span
# collector.
#
# The port's own copy of what aiko_services_tpu/observe/tracing.py gives
# the actor layer and the pipeline: TraceContext(trace_id, span_id,
# parent_id, deadline), the ambient (thread-local) context, and the
# process-wide Tracer, OFF by default (enable with AIKO_TRACE=1 or
# tracer.enable()): recording when disabled is one attribute check.
#
# Clock domains: a deadline is absolute in the LOCAL engine clock.  On
# the wire (a trailing marker parameter of an S-expression payload) it
# travels as remaining seconds plus the sender's send timestamp; when
# the receiver's clock is comparable to the sender's (elapsed time
# within CLOCK_COMPARABLE_HORIZON) transit is charged to the budget.

from __future__ import annotations

import os
import threading
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "TRACE_MARKER", "TraceContext", "new_trace", "new_span_id",
    "current_trace", "activate", "pop_trace", "Tracer", "tracer",
    "SpanRecord",
]

# the marker that opens a trace context's wire field list
TRACE_MARKER = "__aikt__"


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


_new_id = new_span_id

# Largest believable transit+queue time: an elapsed (receiver_now -
# sender_sent) inside this window means the two clocks are comparable
# (same engine, or same-host CLOCK_MONOTONIC); offsets between
# unrelated monotonic clocks are boot-time-sized, far outside it.
CLOCK_COMPARABLE_HORIZON = 3600.0


class TraceContext:
    """One position in a distributed trace, plus the frame's deadline."""
    __slots__ = ("trace_id", "span_id", "parent_id", "deadline", "sent")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str | None = None,
                 deadline: float | None = None,
                 sent: float | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.deadline = deadline
        self.sent = sent            # sender clock at serialization

    def __repr__(self):
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"{' deadline' if self.deadline is not None else ''})")

    def child(self) -> "TraceContext":
        """A child context for one hop: new span id, same trace and
        deadline — the end-to-end budget is inherited, never reset."""
        return TraceContext(self.trace_id, _new_id(),
                            parent_id=self.span_id,
                            deadline=self.deadline)

    def remaining(self, now: float) -> float | None:
        """Budget left at `now` (local engine clock); None = no SLO."""
        return None if self.deadline is None else self.deadline - now

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    # -- wire form ---------------------------------------------------------
    def to_fields(self, now: float) -> list:
        """Serializable field list (all strings — sexpr/envelope safe).
        The deadline crosses as remaining-seconds (see module doc)."""
        remaining = "" if self.deadline is None \
            else repr(self.deadline - now)
        return [TRACE_MARKER, self.trace_id, self.span_id,
                remaining, repr(now)]

    @classmethod
    def from_fields(cls, fields, now: float) -> "TraceContext | None":
        """Inverse of to_fields; tolerant of malformed input (a trace
        header must never fail a data-plane message)."""
        if not isinstance(fields, (list, tuple)) or len(fields) < 3 \
                or fields[0] != TRACE_MARKER:
            return None
        trace_id, span_id = str(fields[1]), str(fields[2])
        deadline = sent = None
        try:
            if len(fields) > 4 and fields[4] not in ("", None):
                sent = float(fields[4])
            if len(fields) > 3 and fields[3] not in ("", None):
                remaining = float(fields[3])
                if sent is not None:
                    elapsed = now - sent
                    if 0.0 <= elapsed <= CLOCK_COMPARABLE_HORIZON:
                        # comparable clocks: transit + queue dwell are
                        # part of the end-to-end budget (module doc)
                        remaining -= elapsed
                deadline = now + remaining
        except (TypeError, ValueError):
            deadline = sent = None
        return cls(trace_id, span_id, deadline=deadline, sent=sent)


def pop_trace(parameters):
    """Strip a trailing trace-context marker from a decoded parameter
    list; returns the marker's field list or None."""
    if isinstance(parameters, list) and parameters:
        last = parameters[-1]
        if isinstance(last, (list, tuple)) and last and \
                isinstance(last[0], str) and last[0] == TRACE_MARKER:
            return list(parameters.pop())
    return None


def new_trace(deadline: float | None = None) -> TraceContext:
    """A fresh root context (new trace id)."""
    return TraceContext(_new_id(), _new_id(), deadline=deadline)


# -- ambient context ---------------------------------------------------------
# Thread-local, not a contextvar: the event engine dispatches handlers
# synchronously per thread, and transport threads must not inherit an
# unrelated caller's context.

_ambient = threading.local()


def current_trace() -> TraceContext | None:
    return getattr(_ambient, "context", None)


@contextmanager
def activate(context: TraceContext | None):
    """Make `context` the ambient trace for the duration (None = no-op
    passthrough, so call sites need no branching)."""
    previous = getattr(_ambient, "context", None)
    _ambient.context = context if context is not None else previous
    try:
        yield context
    finally:
        _ambient.context = previous


# -- span collection ----------------------------------------------------------

@dataclass
class SpanRecord:
    """One finished span, Chrome-trace shaped (ts/dur in seconds)."""
    name: str
    ts: float
    dur: float
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    cat: str = ""
    proc: str = ""
    args: dict = field(default_factory=dict)


class Tracer:
    """Process-wide bounded span buffer."""

    def __init__(self, maxlen: int = 65536, enabled: bool = False):
        self.enabled = enabled
        self.spans: deque = deque(maxlen=maxlen)
        # span taps: callables invoked with each finished SpanRecord (the
        # flight recorder's intake); a broken tap must not stop tracing
        self.taps: list = []

    def enable(self, maxlen: int | None = None) -> None:
        if maxlen is not None and maxlen != self.spans.maxlen:
            self.spans = deque(self.spans, maxlen=maxlen)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, name: str, ts: float, dur: float,
               context: TraceContext | None = None, cat: str = "",
               proc: str = "", args: dict | None = None,
               span_id: str | None = None,
               parent_id: str | None = None) -> None:
        """Record one finished span.  With `context`, ids default to the
        context's OWN ids (the span IS that context's hop); pass span_id
        to mint a child of the context instead."""
        if not self.enabled:
            return
        if context is not None:
            trace_id = context.trace_id
            if span_id is None:
                span_id = context.span_id
                parent_id = parent_id or context.parent_id or ""
            else:
                parent_id = parent_id or context.span_id
        else:
            trace_id = ""
        span = SpanRecord(
            name=name, ts=ts, dur=dur, trace_id=trace_id,
            span_id=span_id or "", parent_id=parent_id or "",
            cat=cat, proc=proc, args=dict(args or {}))
        self.spans.append(span)
        for tap in self.taps:
            try:
                tap(span)
            except Exception:
                pass


tracer = Tracer(enabled=os.environ.get("AIKO_TRACE", "").lower() not in
                ("", "0", "false", "no", "off"))
