# Method tracing: interceptors on service objects.
#
# The port's own copy of aiko_services_tpu/trace.py: trace_all_methods
# wraps every public method of an instance with an interceptor (per
# instance: instance attributes shadow class methods) and untrace
# removes the wrappers.  print_tracer prints enter / exit; TraceCollector
# records structured spans (name, wall time, nesting by thread) and is
# the local leaf of the distributed tracing model (observe/tracing.py):
# finished spans also feed the process-wide Tracer, stamped with the
# ambient TraceContext's trace id, so a method call made while serving a
# remote frame shows in the same Chrome trace as the hop that caused it.

from __future__ import annotations

import functools
import itertools
import threading
import time

from .observe import tracing as _tracing

__all__ = ["trace_all_methods", "untrace", "print_tracer",
           "TraceCollector", "Span"]

_span_ids = itertools.count(1)


class Span:
    __slots__ = ("span_id", "parent_id", "name", "start", "duration",
                 "error")

    def __init__(self, span_id, parent_id, name, start):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.duration = None
        self.error = None

    def __repr__(self):
        ms = f"{self.duration * 1e3:.2f}ms" if self.duration is not None \
            else "…"
        return f"Span({self.name} {ms})"


class TraceCollector:
    """Interceptor that records spans with caller/callee nesting.

    The nesting stack is THREAD-LOCAL: spans recorded concurrently from
    the event-loop thread and a caller thread (e.g. a batching
    scheduler's drive thread resolving a deferred while the engine
    walks the next frame) each nest under their own thread's open span
    — a shared stack would cross-link parents between threads and pop
    the wrong span on exit."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.spans: list[Span] = []         # append-only (GIL-safe)
        self._local = threading.local()

    @property
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def __call__(self, name, method, args, kwargs):
        stack = self._stack
        parent = stack[-1].span_id if stack else None
        span = Span(next(_span_ids), parent, name, self.clock())
        self.spans.append(span)
        stack.append(span)
        try:
            return method(*args, **kwargs)
        except Exception as exc:
            span.error = repr(exc)
            raise
        finally:
            span.duration = self.clock() - span.start
            stack.pop()
            # local leaf of the distributed model: finished spans feed
            # the process Tracer under the ambient trace context
            tracer = _tracing.tracer
            if tracer.enabled:
                tracer.record(
                    f"call:{name}", span.start, span.duration,
                    context=_tracing.current_trace(), cat="method",
                    span_id=_tracing.new_span_id(),
                    args={"error": span.error or ""})


def print_tracer(name, method, args, kwargs):
    """The reference's proxy_trace equivalent: enter/exit prints.
    Deliberately console-bound (it exists to eyeball a live object),
    hence the lint-print waivers."""
    print(f"TRACE enter {name}{args!r}")      # graft: disable=lint-print
    try:
        return method(*args, **kwargs)
    finally:
        print(f"TRACE exit  {name}")          # graft: disable=lint-print


def trace_all_methods(instance, interceptor, only=None) -> list[str]:
    """Wrap every public bound method of `instance` with
    interceptor(name, method, args, kwargs).  Returns the wrapped names.
    `only` restricts to the given method names."""
    import inspect

    wrapped = []
    for name in dir(instance):
        if name.startswith("_"):
            continue
        if only is not None and name not in only:
            continue
        # inspect statically first: plain getattr would EXECUTE property
        # getters (service classes here define several, with side effects)
        static = inspect.getattr_static(instance, name, None)
        if not (inspect.isfunction(static) or inspect.ismethod(static)):
            continue
        method = getattr(instance, name)
        if not callable(method) or not hasattr(method, "__self__"):
            continue

        @functools.wraps(method)
        def wrapper(*args, _name=name, _method=method, **kwargs):
            return interceptor(_name, _method, args, kwargs)

        wrapper.__traced__ = method
        instance.__dict__[name] = wrapper
        wrapped.append(name)
    return wrapped


def untrace(instance) -> None:
    """Remove all trace wrappers installed by trace_all_methods."""
    for name, value in list(instance.__dict__.items()):
        if hasattr(value, "__traced__"):
            del instance.__dict__[name]
