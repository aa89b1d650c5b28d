# The flight recorder: a per-runtime bounded ring of recent evidence.
#
# The port's own copy of aiko_services_tpu/observe/flight.py.  Each
# FlightRecorder keeps plain deque(maxlen) rings of
#
#   * spans   - tapped off the process-wide Tracer, routed to the recorder
#     whose runtime owns the span's proc name (unclaimed spans land in the
#     first-registered recorder);
#   * samples - periodic (engine-timer) readings of registry counter and
#     gauge values and histogram counts;
#   * logs    - records fanned in by FlightLogHandler (WARNING+ by
#     default);
#   * faults  - injected faults, recorded through the module-level
#     record_fault() hook (transport/chaos.py's FaultPlan, the KV
#     ledger's violations): registering a recorder is enough.
#
# Appends are GIL-atomic, no lock on any recording path.  merge() / dump()
# write every registered recorder's rings as one Chrome trace-event
# timeline (one pid per recorder); DumpOnAlert writes one dump per SLO
# rule that fires; the {topic_path}/0/flight control topic dumps on
# request.  Spans carry perf_counter stamps, samples / faults / logs the
# engine clock: each domain is normalized to its own zero.

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

from .export import series_key
from .metrics import MetricsRegistry, default_registry
from .tracing import SpanRecord, tracer as _global_tracer
from ..utils import get_logger, parse

__all__ = [
    "FlightRecorder", "FlightLogHandler", "DumpOnAlert",
    "FLIGHT_TOPIC_SUFFIX", "record_fault", "register", "unregister",
    "recorders", "merge", "dump",
]

FLIGHT_TOPIC_SUFFIX = "0/flight"
_DEFAULT_RING = 4096

_logger = get_logger("observe.flight")
_recorders: list["FlightRecorder"] = []


def register(recorder: "FlightRecorder") -> None:
    if recorder not in _recorders:
        _recorders.append(recorder)
    _install_tracer_tap()


def unregister(recorder: "FlightRecorder") -> None:
    if recorder in _recorders:
        _recorders.remove(recorder)


def recorders() -> list:
    return list(_recorders)


def record_fault(kind: str, topic: str = "", sender: str = "",
                 recipient: str = "", t: float | None = None) -> None:
    """Module-level fault hook: FaultPlan calls this at every injected
    fault; a no-op (one empty-list check) when no recorder is
    registered, so chaos runs without a flight recorder pay nothing."""
    if not _recorders:
        return
    if t is None:
        t = time.monotonic()
    event = (float(t), str(kind), str(topic), str(sender),
             str(recipient))
    for recorder in _recorders:
        recorder.faults.append(event)


def _tracer_tap(span: SpanRecord) -> None:
    """Route one finished span to the recorder(s) owning its proc name;
    unclaimed spans fall to the first-registered recorder."""
    if not _recorders:
        return
    claimed = False
    for recorder in _recorders:
        if span.proc and span.proc in recorder.owned_procs():
            recorder.spans.append(span)
            claimed = True
    if not claimed:
        _recorders[0].spans.append(span)


def _install_tracer_tap(trace_source=None) -> None:
    source = trace_source or _global_tracer
    if _tracer_tap not in source.taps:
        source.taps.append(_tracer_tap)


class FlightLogHandler(logging.Handler):
    """Fans WARNING+ log records into every registered recorder's log
    ring — attach to any logger tree the runtime cares about."""

    def __init__(self, level=logging.WARNING):
        super().__init__(level)

    def emit(self, record: logging.LogRecord) -> None:
        if not _recorders:
            return
        try:
            message = record.getMessage()
        except Exception:
            return
        for recorder in _recorders:
            # stamped on EACH recorder's engine clock (virtual in
            # tests), not record.created wall-epoch — the merge
            # normalizes logs in the engine domain, and an epoch
            # timestamp would land the instant decades off-timeline
            recorder.logs.append((recorder._now(), record.levelname,
                                  record.name, message))


class FlightRecorder:
    """Per-runtime evidence ring; see module doc.

    `runtime` (optional) provides proc-name ownership for span routing,
    the engine timer for periodic metric sampling
    (`sample_interval` > 0), and the control-topic RPC
    ({topic_path}/0/flight, payload "(dump <pathname>)" → merged dump
    written, reply "(dumped <pathname> <events>)" on .../flight/out).
    Without a runtime it is a bare ring the caller feeds directly."""

    def __init__(self, runtime=None, name: str | None = None,
                 maxlen: int = _DEFAULT_RING,
                 sample_interval: float = 0.0, families=None,
                 registry: MetricsRegistry | None = None,
                 rpc: bool = True):
        self.runtime = runtime
        self.name = name or (getattr(runtime, "name", None) or "flight")
        self.registry = registry or default_registry()
        self.families = set(families) if families is not None else None
        self.spans: deque = deque(maxlen=maxlen)
        self.samples: deque = deque(maxlen=maxlen)
        self.logs: deque = deque(maxlen=maxlen)
        self.faults: deque = deque(maxlen=maxlen)
        self._timer = None
        self._rpc_topic = None
        self._dump_worker = None
        if runtime is not None and sample_interval > 0:
            self._timer = runtime.event.add_timer_handler(
                self.sample_now, float(sample_interval))
        if runtime is not None and rpc:
            self._rpc_topic = \
                f"{runtime.topic_path}/{FLIGHT_TOPIC_SUFFIX}"
            runtime.add_message_handler(self._rpc_handler,
                                        self._rpc_topic)
        register(self)

    def _now(self) -> float:
        """This recorder's engine-domain clock (monotonic fallback for
        bare recorders) — samples/faults/logs all stamp with it."""
        return self.runtime.event.clock.now() if self.runtime \
            is not None else time.monotonic()

    def owned_procs(self) -> set:
        """Proc names this recorder claims spans for: the runtime's own
        name plus every registered service's (pipelines and actors
        record spans under their service name, not the runtime's)."""
        if self.runtime is None:
            return {self.name}
        owned = {self.runtime.name}
        for service in self.runtime.services().values():
            service_name = getattr(service, "name", None)
            if service_name:
                owned.add(service_name)
        return owned

    # -- recording ----------------------------------------------------------
    def record_span(self, span: SpanRecord) -> None:
        self.spans.append(span)

    def record_sample(self, t: float, key: str, value) -> None:
        self.samples.append((float(t), str(key), value))

    def record_log(self, t: float, level: str, logger_name: str,
                   message: str) -> None:
        self.logs.append((float(t), level, logger_name, message))

    def record_fault(self, t: float, kind: str, topic: str = "",
                     sender: str = "", recipient: str = "") -> None:
        self.faults.append((float(t), kind, topic, sender, recipient))

    def sample_now(self) -> None:
        """One registry sweep into the sample ring: counter/gauge
        values and histogram observation counts, keyed
        'family{labels}' (observe.export.series_key form)."""
        t = self._now()
        for name, entry in self.registry.snapshot().items():
            if self.families is not None and name not in self.families:
                continue
            for series in entry.get("series", []):
                key = series_key(name, series.get("labels", {}))
                # self.samples is a deque(maxlen=...) sized at
                # construction — bounded by the ring, shed-oldest
                if entry.get("type") == "histogram":
                    self.samples.append(  # graft: disable=lint-unbounded-queue
                        (t, f"{key}:count", series.get("count", 0)))
                else:
                    self.samples.append(  # graft: disable=lint-unbounded-queue
                        (t, key, series.get("value", 0)))

    # -- RPC ----------------------------------------------------------------
    def _rpc_handler(self, _topic, payload) -> None:
        try:
            if isinstance(payload, (bytes, bytearray)):
                payload = payload.decode("utf-8")
            command, params = parse(payload)
        except Exception:
            return
        if command != "dump" or not params:
            return
        pathname = str(params[0])
        # the merged dump is synchronous file I/O — seconds for a full
        # ring — so it runs on a worker thread, not the event loop;
        # the reply publishes from that thread, which is the same
        # off-loop delivery the MQTT network thread already does
        worker = threading.Thread(
            target=self._dump_and_reply,
            args=(pathname, f"{self._rpc_topic}/out"),
            name=f"flight-dump:{self.name}", daemon=True)
        self._dump_worker = worker
        worker.start()

    def _dump_and_reply(self, pathname: str, reply_topic: str) -> None:
        try:
            dump(pathname)
            events = sum(len(r.spans) + len(r.samples) + len(r.faults)
                         + len(r.logs) for r in _recorders)
            self.runtime.publish(reply_topic,
                                 f"(dumped {pathname} {events})")
        except Exception:
            _logger.exception("flight %s: RPC dump to %s failed",
                              self.name, pathname)

    def close(self) -> None:
        if self.runtime is not None:
            if self._timer is not None:
                self.runtime.event.remove_timer_handler(self._timer)
                self._timer = None
            if self._rpc_topic is not None:
                self.runtime.remove_message_handler(self._rpc_handler,
                                                    self._rpc_topic)
                self._rpc_topic = None
        unregister(self)


# -- merged dump --------------------------------------------------------------

def _span_events(recorder: FlightRecorder, pid: int, t0: float) -> list:
    events, seen = [], set()
    for span in list(recorder.spans):
        key = (span.trace_id, span.span_id, span.name, span.ts)
        if key in seen:
            continue
        seen.add(key)
        args = {"trace_id": span.trace_id, "span_id": span.span_id,
                "parent_id": span.parent_id, "proc": span.proc}
        args.update(span.args)
        events.append({
            "name": span.name, "cat": span.cat or "span", "ph": "X",
            "ts": round((span.ts - t0) * 1e6, 3),
            "dur": max(round(span.dur * 1e6, 3), 0.001),
            "pid": pid, "tid": 1, "args": args,
        })
    return events


def merge(recorder_list=None) -> dict:
    """Merge every recorder's rings into one Chrome trace-event
    document (Perfetto-loadable): one pid per recorder, spans "X",
    samples "C", faults/logs instant "i".  Each clock domain is
    normalized to its own zero (module doc)."""
    sources = recorder_list if recorder_list is not None \
        else list(_recorders)
    events: list[dict] = []
    span_t0 = min((s.ts for r in sources for s in r.spans),
                  default=0.0)
    engine_ts = [e[0] for r in sources
                 for ring in (r.samples, r.faults, r.logs)
                 for e in ring]
    engine_t0 = min(engine_ts, default=0.0)
    for index, recorder in enumerate(sources):
        pid = index + 1
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": recorder.name}})
        events.extend(_span_events(recorder, pid, span_t0))
        for t, key, value in list(recorder.samples):
            events.append({"name": key, "ph": "C", "pid": pid,
                           "ts": round((t - engine_t0) * 1e6, 3),
                           "args": {"value": value}})
        for t, kind, topic, sender, recipient in list(recorder.faults):
            events.append({"name": f"fault:{kind}", "ph": "i",
                           "s": "g", "pid": pid, "tid": 1,
                           "ts": round((t - engine_t0) * 1e6, 3),
                           "args": {"topic": topic, "sender": sender,
                                    "recipient": recipient}})
        for t, level, logger_name, message in list(recorder.logs):
            events.append({"name": f"log:{level}", "ph": "i", "s": "t",
                           "pid": pid, "tid": 1,
                           "ts": round((t - engine_t0) * 1e6, 3),
                           "args": {"logger": logger_name,
                                    "message": message}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump(pathname, recorder_list=None, reason: str = "",
         metadata: dict | None = None) -> str:
    """Write the merged timeline to `pathname`; returns the path.
    `metadata` merges extra keys into the document's metadata block —
    DumpOnAlert ships the firing alert's exemplar trace ids there, so
    the artifact itself names which traces to open first."""
    document = merge(recorder_list)
    if reason or metadata:
        document["metadata"] = {**({"reason": reason} if reason
                                   else {}), **(metadata or {})}
    with open(pathname, "w", encoding="utf-8") as f:
        json.dump(document, f)
    _logger.info("flight recorder dump -> %s (%d events%s)", pathname,
                 len(document["traceEvents"]),
                 f", reason={reason}" if reason else "")
    return str(pathname)


class DumpOnAlert:
    """HealthAggregator.on_alert callback: writes ONE merged dump per
    rule into `directory` — every breach ships exactly one postmortem
    artifact, however many evaluation ticks it stays breached (the
    aggregator already edge-triggers; the latch here also survives
    flapping rules re-firing)."""

    def __init__(self, directory, prefix: str = "flight"):
        self.directory = str(directory)
        self.prefix = prefix
        self.dumped: dict[str, str] = {}       # rule name -> path

    def __call__(self, rule, record) -> str | None:
        name = getattr(rule, "name", str(rule))
        if name in self.dumped:
            return None
        pathname = f"{self.directory}/{self.prefix}_{name}.json"
        exemplars = (record or {}).get("exemplars") or []
        self.dumped[name] = dump(
            pathname, reason=f"slo-breach:{name}",
            metadata={"exemplars": list(exemplars)} if exemplars
            else None)
        return self.dumped[name]
