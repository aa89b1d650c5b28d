# Telemetry export: Prometheus text, Chrome trace events, live publish.
#
# The port's own copy of aiko_services_tpu/observe/export.py:
#
#   * render_prometheus / render_snapshot_prometheus: a registry snapshot
#     in Prometheus text exposition format (sketches as summaries);
#   * chrome_trace / dump_chrome_trace: the Tracer's span buffer
#     (observe/tracing.py) as a Chrome trace-event JSON document;
#   * MetricsPublisher: a periodic retained snapshot on the control-plane
#     topic {topic_path}/0/metrics, driven by the runtime's event engine,
#     so the dashboard, the autoscaler, the health aggregator and the
#     recorder see the latest numbers without asking;
#   * parse_retained_json / series_key / series_quantile: the one decode
#     and the flattening every snapshot consumer shares.

from __future__ import annotations

import json
import random
import time
import zlib

from .metrics import MetricsRegistry, default_registry
from .sketch import Sketch
from .tracing import Tracer, tracer as _global_tracer

__all__ = [
    "render_prometheus", "render_snapshot_prometheus", "chrome_trace",
    "dump_chrome_trace", "MetricsPublisher", "METRICS_TOPIC_SUFFIX",
    "parse_retained_json", "series_key", "series_quantile",
]


def parse_retained_json(payload, require_key: str | None = None):
    """Decode one retained control-plane JSON payload (metrics
    snapshot, alert record): bytes-tolerant, returns the dict or None
    on any malformed input — a bad retained record must never fail a
    subscriber.  `require_key` additionally rejects documents missing
    that key.  The ONE decode shared by every snapshot/alert consumer
    (HealthAggregator, Autoscaler, Recorder, Dashboard, metrics_dump),
    so framing changes have a single seam."""
    try:
        if isinstance(payload, (bytes, bytearray)):
            payload = payload.decode("utf-8")
        document = json.loads(payload)
    except Exception:
        return None
    if not isinstance(document, dict):
        return None
    if require_key is not None and require_key not in document:
        return None
    return document

METRICS_TOPIC_SUFFIX = "0/metrics"


def series_key(name: str, labels: dict) -> str:
    """Display key 'name{k=v,...}' for one snapshot series — the shared
    flattening used by the soak report and the dashboard pane (plain
    join, no escaping; Prometheus exposition has its own _label_text)."""
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}" if inner else name


def series_quantile(series: dict, q: float) -> float:
    """Approximate quantile from one snapshot histogram series
    (bounds/counts/count as emitted by MetricsRegistry.snapshot()),
    mirroring Histogram.quantile: the upper bound of the bucket holding
    the q-th observation; diagnostic-grade."""
    count = series.get("count", 0)
    bounds = series.get("bounds") or []
    if not count or not bounds:
        return 0.0
    target = q * count
    running = 0
    for index, bucket_count in enumerate(series.get("counts", [])):
        running += bucket_count
        if running >= target:
            return bounds[min(index, len(bounds) - 1)]
    return bounds[-1]


def _escape(value: str) -> str:
    return str(value).replace("\\", r"\\").replace("\n", r"\n") \
        .replace('"', r'\"')


def _label_text(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{key}="{_escape(value)}"'
                     for key, value in sorted(merged.items()))
    return "{" + inner + "}"


def _format_value(value) -> str:
    if isinstance(value, float):
        return repr(value)
    return str(value)


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """The registry in Prometheus text exposition format (v0.0.4)."""
    return render_snapshot_prometheus(
        (registry or default_registry()).snapshot())


def render_snapshot_prometheus(snapshot: dict,
                               extra_labels: dict | None = None) -> str:
    """One already-captured MetricsRegistry.snapshot() document as
    Prometheus text exposition.  `extra_labels` merge into every
    series — the metrics_dump CLI stamps the publishing process's
    topic_path so a fleet-wide scrape stays per-process attributable."""
    lines: list[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        if entry.get("help"):
            lines.append(f"# HELP {name} {entry['help']}")
        kind = entry.get("type", "gauge")
        # sketches render as Prometheus summaries (quantile labels) —
        # "sketch" is not a text-exposition type
        lines.append(f"# TYPE {name} "
                     f"{'summary' if kind == 'sketch' else kind}")
        for series in entry.get("series", []):
            labels = {**series.get("labels", {}),
                      **(extra_labels or {})}
            if entry.get("type") == "histogram":
                cumulative = 0
                for bound, count in zip(series.get("bounds", ()),
                                        series.get("counts", ())):
                    cumulative += count
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_text(labels, {'le': repr(bound)})} "
                        f"{cumulative}")
                lines.append(
                    f"{name}_bucket{_label_text(labels, {'le': '+Inf'})} "
                    f"{series.get('count', 0)}")
                lines.append(f"{name}_sum{_label_text(labels)} "
                             f"{_format_value(series.get('sum', 0.0))}")
                lines.append(f"{name}_count{_label_text(labels)} "
                             f"{series.get('count', 0)}")
            elif entry.get("type") == "sketch":
                # Prometheus has no sketch type: expose as a summary
                # (quantile labels) so scrapers get readable numbers;
                # the MERGEABLE form lives in the JSON snapshot, not
                # this lossy text view
                sketch = Sketch.from_dict(series)
                for q in (0.5, 0.95, 0.99):
                    value = sketch.quantile(q) if sketch else None
                    if value is not None:
                        lines.append(
                            f"{name}"
                            f"{_label_text(labels, {'quantile': str(q)})}"
                            f" {_format_value(value)}")
                lines.append(f"{name}_sum{_label_text(labels)} "
                             f"{_format_value(series.get('sum', 0.0))}")
                lines.append(f"{name}_count{_label_text(labels)} "
                             f"{series.get('count', 0)}")
            else:
                lines.append(f"{name}{_label_text(labels)} "
                             f"{_format_value(series.get('value', 0))}")
    return "\n".join(lines) + ("\n" if lines else "")


def chrome_trace(trace_source: Tracer | None = None) -> dict:
    """The tracer's span buffer as a Chrome trace-event document
    (Perfetto-loadable JSON: complete "X" events, µs timestamps, one
    pid per recording process name, trace/span ids in args)."""
    source = trace_source or _global_tracer
    pids: dict[str, int] = {}
    events: list[dict] = []
    for span in list(source.spans):
        proc = span.proc or "aiko"
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": proc}})
        args = {"trace_id": span.trace_id, "span_id": span.span_id,
                "parent_id": span.parent_id}
        args.update(span.args)
        events.append({
            "name": span.name, "cat": span.cat or "span", "ph": "X",
            "ts": round(span.ts * 1e6, 3),
            "dur": max(round(span.dur * 1e6, 3), 0.001),
            "pid": pid, "tid": 1, "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(pathname, trace_source: Tracer | None = None) -> str:
    """Write the Chrome trace-event document to `pathname`."""
    document = chrome_trace(trace_source)
    with open(pathname, "w", encoding="utf-8") as f:
        json.dump(document, f)
    return str(pathname)


class MetricsPublisher:
    """Periodic retained metrics snapshots on a control-plane topic.

    Publishes {"process", "topic_path", "time", "snapshot"} as JSON to
    {runtime.topic_path}/0/metrics every `interval` seconds (engine
    timers, so virtual-clock tests drive it deterministically).
    Retained by default: a dashboard opening the pane later still sees
    the last snapshot, like the process state topic.

    Interval jitter: a fleet of publishers all constructed
    at process start with the same interval synchronizes into periodic
    broker bursts — every runtime serializes its whole registry in the
    same engine tick.  With `jitter` > 0 each publish reschedules
    itself as a oneshot at interval × (1 ± jitter), drawn from a
    SEEDED generator (seed defaults to a hash of the topic, so a
    process's schedule is reproducible run-to-run while distinct
    topics decorrelate).  Default 0: windowed-delta tests pin exact
    cadence; FLEET contexts (the bench wire runtimes, scaled soaks)
    arm it.  The publish cost itself is observable:
    `metrics_publish_seconds` gauge (serialize + publish wall)."""

    def __init__(self, runtime, interval: float = 5.0,
                 topic: str | None = None,
                 registry: MetricsRegistry | None = None,
                 retain: bool = True, jitter: float = 0.0,
                 jitter_seed: int | None = None):
        self.runtime = runtime
        self.registry = registry or default_registry()
        self.topic = topic or \
            f"{runtime.topic_path}/{METRICS_TOPIC_SUFFIX}"
        self.retain = retain
        self.interval = float(interval)
        self.jitter = max(0.0, min(float(jitter), 0.9))
        self._rng = random.Random(
            jitter_seed if jitter_seed is not None
            else zlib.crc32(self.topic.encode("utf-8")))
        # labelled by the runtime's NAME (bounded: a handful of
        # runtimes per process) — two publishers sharing the process
        # registry must not overwrite each other's cost reading
        self._cost_gauge = self.registry.gauge(
            "metrics_publish_seconds",
            "wall seconds the last snapshot publish cost "
            "(serialize + publish)",
            labels={"publisher": str(getattr(runtime, "name", None)
                                     or "metrics")})
        self._timer = None
        self._stopped = False
        if self.jitter:
            # jittered publishers re-arm a ONESHOT per publish (each
            # delay drawn fresh); unjittered ones keep the periodic
            # timer, whose heap reschedule (due += period) is EXACT —
            # the windowed-delta tests pin that cadence
            self._schedule()
        else:
            self._timer = runtime.event.add_timer_handler(
                self.publish_now, self.interval)

    def _next_delay(self) -> float:
        return self.interval * (
            1.0 + self._rng.uniform(-self.jitter, self.jitter))

    def _schedule(self) -> None:
        self._timer = self.runtime.event.add_oneshot_handler(
            self._tick, self._next_delay())

    def _tick(self) -> None:
        self._timer = None
        try:
            self.publish_now()
        finally:
            if not self._stopped:
                self._schedule()

    def publish_now(self) -> None:
        started = time.perf_counter()
        document = {
            "process": self.runtime.name,
            "topic_path": self.runtime.topic_path,
            "time": self.runtime.event.clock.now(),
            "snapshot": self.registry.snapshot(),
        }
        self.runtime.publish(self.topic,
                             json.dumps(document, default=str),
                             retain=self.retain)
        self._cost_gauge.set(time.perf_counter() - started)

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self.runtime.event.remove_timer_handler(self._timer)
            self._timer = None
