# The fleet health plane: a time-series store over the retained metrics
# snapshots, declarative SLO rules with multi-window burn-rate alerting,
# and the HealthAggregator that evaluates them fleet-wide.
#
# The port's own copy of aiko_services_tpu/observe/series.py:
#
#   * SeriesStore: a bounded ring of history per (source, series):
#     counters and gauges as (t, value) samples, histograms as
#     (t, bucket counts) so windowed quantiles come from bucket-count
#     deltas, sketches as (t, payload) merged across sources into one
#     fleet-true windowed sketch;
#   * SLORule: rules over series selectors ("family{label=value}:p95"):
#     `ratio` rules burn an error budget and fire only when both windows
#     of a (long, short, threshold) pair burn; `level` rules watch a
#     windowed worst value with a persistence requirement;
#   * HealthAggregator: subscribes the retained {topic}/0/metrics
#     snapshots of the namespace, appends them into the store, evaluates
#     the rules each tick on the runtime's engine, and publishes retained
#     alert records on {namespace}/alert/{rule}.
#
# The aggregator is duck-typed on the ProcessRuntime surface
# (add_message_handler / publish / event), not an Actor: importing
# actor.py here would cycle the import graph.

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass

from .export import METRICS_TOPIC_SUFFIX, parse_retained_json
from .metrics import MetricsRegistry, default_registry
from .sketch import Sketch, merge_sketches
from ..utils import get_logger

__all__ = [
    "ScalarSeries", "HistogramSeries", "SketchSeries", "SeriesStore",
    "SLORule", "HealthAggregator", "parse_selector",
    "ALERT_TOPIC_PREFIX",
]

ALERT_TOPIC_PREFIX = "alert"

# samples kept per series ring: at the MetricsPublisher's default 5 s
# interval this covers ~5 minutes of history; tighter intervals shorten
# the window rather than growing memory (the store is bounded by
# construction, like every other ring in the runtime)
DEFAULT_RING_SAMPLES = 64


def parse_selector(text: str):
    """Parse a series selector "family{label=value,...}:pNN" into
    (family, labels dict, quantile or None).  Labels are a SUBSET
    match; the quantile suffix selects a histogram percentile (p95 →
    0.95).  The grammar is deliberately tiny — it has to be writable in
    a soak script and readable in an alert record."""
    text = text.strip()
    quantile = None
    base, sep, suffix = text.rpartition(":")
    if sep and suffix.startswith("p"):
        try:
            quantile = float(suffix[1:]) / 100.0
            text = base
        except ValueError:
            quantile = None
    labels: dict = {}
    if text.endswith("}") and "{" in text:
        text, _, inner = text.partition("{")
        for pair in inner[:-1].split(","):
            if not pair.strip():
                continue
            key, _, value = pair.partition("=")
            labels[key.strip()] = value.strip()
    return text, labels, quantile


class ScalarSeries:
    """Bounded ring of (t, value) samples for one counter/gauge series."""
    __slots__ = ("name", "labels", "kind", "points")

    def __init__(self, name: str, labels: dict, kind: str,
                 maxlen: int = DEFAULT_RING_SAMPLES):
        self.name = name
        self.labels = dict(labels)
        self.kind = kind                       # "counter" | "gauge"
        self.points: deque = deque(maxlen=maxlen)

    def append(self, t: float, value: float) -> None:
        self.points.append((float(t), float(value)))

    def _window(self, now: float, window: float) -> list:
        cutoff = now - window
        return [(t, v) for t, v in self.points if t >= cutoff]

    def latest(self, now: float, window: float):
        """Most recent value within the window, or None — the
        freshness-bounded LEVEL read (replaces the autoscaler's ad-hoc
        snapshot-horizon staleness pruning)."""
        points = self._window(now, window)
        return points[-1][1] if points else None

    def maximum(self, now: float, window: float):
        points = self._window(now, window)
        return max(v for _, v in points) if points else None

    def delta(self, now: float, window: float) -> float:
        """newest - oldest value inside the window; 0.0 with fewer than
        two samples.  A single sample is a BASELINE, not a delta — this
        is what keeps cumulative counters from an earlier scenario (the
        registry is process-wide) out of this window's rate."""
        points = self._window(now, window)
        if len(points) < 2:
            return 0.0
        return points[-1][1] - points[0][1]

    def trend(self, now: float, window: float):
        """Slope in value/second over the window (None with <2 samples
        or zero time spread) — the leading-edge signal a level
        threshold only sees after the fact."""
        points = self._window(now, window)
        if len(points) < 2:
            return None
        dt = points[-1][0] - points[0][0]
        if dt <= 0:
            return None
        return (points[-1][1] - points[0][1]) / dt


class HistogramSeries:
    """Bounded ring of (t, cumulative bucket counts) samples for one
    histogram series — windowed quantiles come from count DELTAS."""
    __slots__ = ("name", "labels", "bounds", "points")

    def __init__(self, name: str, labels: dict, bounds,
                 maxlen: int = DEFAULT_RING_SAMPLES):
        self.name = name
        self.labels = dict(labels)
        self.bounds = tuple(float(b) for b in bounds)
        self.points: deque = deque(maxlen=maxlen)

    def append(self, t: float, counts) -> None:
        self.points.append((float(t), tuple(int(c) for c in counts)))

    def _window(self, now: float, window: float) -> list:
        cutoff = now - window
        return [(t, c) for t, c in self.points if t >= cutoff]

    def delta_counts(self, now: float, window: float,
                     baseline_empty: bool = False):
        """Bucket-count deltas across the window (newest - oldest).
        With one sample: None normally (a baseline is not a delta), or
        the sample itself when `baseline_empty` — the first sight of a
        process counts everything it reports (the Autoscaler's
        compatibility mode; rule evaluation never uses it)."""
        points = self._window(now, window)
        if not points:
            return None
        if len(points) < 2:
            return points[-1][1] if baseline_empty else None
        oldest, newest = points[0][1], points[-1][1]
        if len(oldest) != len(newest):
            return newest if baseline_empty else None
        return tuple(max(0, n - o) for n, o in zip(newest, oldest))

    def delta_quantile(self, q: float, now: float, window: float,
                       baseline_empty: bool = False):
        """Approximate windowed quantile (upper bound of the bucket
        holding the q-th windowed observation), or None when the window
        holds no evidence — same diagnostic grade as
        Histogram.quantile, minus the cumulative contamination."""
        counts = self.delta_counts(now, window, baseline_empty)
        if not counts or not self.bounds:
            return None
        total = sum(counts)
        if not total:
            return None
        target = q * total
        running = 0
        for index, bucket_count in enumerate(counts):
            running += bucket_count
            if running >= target:
                return self.bounds[min(index, len(self.bounds) - 1)]
        return self.bounds[-1]

    def delta_count(self, now: float, window: float) -> int:
        counts = self.delta_counts(now, window)
        return sum(counts) if counts else 0


class SketchSeries:
    """Bounded ring of (t, sketch payload dict) samples for one
    mergeable quantile sketch series (observe/sketch.py).  The payload
    is the cumulative to_dict() form straight off the snapshot;
    windowed reads reconstruct a DELTA sketch from the newest/oldest
    pair (bin-count subtraction — same anti-contamination discipline
    as HistogramSeries), and the store merges delta sketches ACROSS
    SOURCES so a level rule reads one fleet-true quantile instead of
    worst-of-per-process."""
    __slots__ = ("name", "labels", "points")

    def __init__(self, name: str, labels: dict,
                 maxlen: int = DEFAULT_RING_SAMPLES):
        self.name = name
        self.labels = dict(labels)
        self.points: deque = deque(maxlen=maxlen)

    def append(self, t: float, payload: dict) -> None:
        self.points.append((float(t), dict(payload)))

    def _window(self, now: float, window: float) -> list:
        cutoff = now - window
        return [(t, p) for t, p in self.points if t >= cutoff]

    def delta_sketch(self, now: float, window: float,
                     baseline_empty: bool = False) -> Sketch | None:
        """The window's worth of observations as a fresh Sketch, or
        None without two samples (a baseline is not a delta; the same
        rule ScalarSeries.delta applies).  Exemplars keep only entries
        whose seq postdates the window-start count — clock-free window
        filtering (sketch.py module doc)."""
        points = self._window(now, window)
        if not points:
            return None
        if len(points) < 2:
            return Sketch.from_dict(points[-1][1], self.name,
                                    self.labels) \
                if baseline_empty else None
        newest = Sketch.from_dict(points[-1][1], self.name, self.labels)
        oldest = Sketch.from_dict(points[0][1])
        if newest is None:
            return None
        if oldest is None or abs(oldest.gamma - newest.gamma) > 1e-12:
            return newest if baseline_empty else None
        delta = Sketch(self.name, self.labels, alpha=newest.alpha,
                       exemplar_k=max(newest.exemplar_k,
                                      len(newest.exemplars) or 1))
        delta.bins = {
            index: count - oldest.bins.get(index, 0)
            for index, count in newest.bins.items()
            if count - oldest.bins.get(index, 0) > 0}
        delta.zero = max(0, newest.zero - oldest.zero)
        delta.count = delta.zero + sum(delta.bins.values())
        delta.sum = max(0.0, newest.sum - oldest.sum)
        delta.exemplars = [list(e) for e in newest.exemplars
                           if e[2] > oldest.count]
        return delta


class SeriesStore:
    """Per-(source, series) history over registry snapshots.

    `source` is the publishing process's topic_path; series identity is
    (family name, label items) exactly as the registry keys them.  The
    store is bounded twice: per-ring sample count and total series
    count (beyond `max_series`, new series are dropped with a counter —
    an unbounded-label bug upstream must not OOM the aggregator; the
    lint-metric-label graft-check rule polices the source)."""

    def __init__(self, window: float = 300.0,
                 ring_samples: int = DEFAULT_RING_SAMPLES,
                 max_series: int = 4096,
                 registry: MetricsRegistry | None = None):
        self.window = float(window)
        self.ring_samples = int(ring_samples)
        self.max_series = int(max_series)
        self._series: dict[tuple, object] = {}
        self._newest: dict[str, float] = {}     # source -> last append t
        registry = registry or default_registry()
        self._dropped = registry.counter(
            "health_series_dropped_total",
            "series refused by the store's max_series bound")

    def __len__(self) -> int:
        return len(self._series)

    @staticmethod
    def _key(source: str, name: str, labels: dict) -> tuple:
        return (source, name, tuple(sorted(labels.items())))

    def _get(self, source, name, labels, factory, ring_class):
        key = self._key(source, name, labels)
        ring = self._series.get(key)
        if ring is not None and not isinstance(ring, ring_class):
            # the source re-shipped this family under the OTHER metric
            # type (publisher upgrade reusing a retained topic_path):
            # the old history is meaningless for the new kind — replace
            # the ring instead of crashing every later snapshot's
            # intake with a type error
            del self._series[key]
            ring = None
        if ring is None:
            if len(self._series) >= self.max_series:
                self._dropped.inc()
                return None
            ring = self._series[key] = factory()
        return ring

    def append_scalar(self, source: str, name: str, labels: dict,
                      t: float, value, kind: str = "gauge",
                      seed_zero_t: float | None = None) -> None:
        key = self._key(source, name, labels)
        new_series = key not in self._series
        ring = self._get(source, name, labels,
                         lambda: ScalarSeries(name, labels, kind,
                                              self.ring_samples),
                         ScalarSeries)
        if ring is not None:
            if new_series and seed_zero_t is not None \
                    and kind != "gauge":
                # series BORN mid-flight from an already-known source
                # (registry counters create lazily on first increment):
                # it was provably zero the last time this source
                # reported, so seed that — without it the birth burst
                # reads as a baseline and the whole first window of
                # events vanishes from every rate
                ring.append(seed_zero_t, 0.0)
            ring.append(t, value)
            self._newest[source] = t

    def append_histogram(self, source: str, name: str, labels: dict,
                         t: float, bounds, counts,
                         seed_zero_t: float | None = None) -> None:
        key = self._key(source, name, labels)
        new_series = key not in self._series
        ring = self._get(source, name, labels,
                         lambda: HistogramSeries(name, labels, bounds,
                                                 self.ring_samples),
                         HistogramSeries)
        if ring is not None:
            if new_series and seed_zero_t is not None:
                ring.append(seed_zero_t, (0,) * len(counts))
            ring.append(t, counts)
            self._newest[source] = t

    def append_sketch(self, source: str, name: str, labels: dict,
                      t: float, payload: dict,
                      seed_zero_t: float | None = None) -> None:
        key = self._key(source, name, labels)
        new_series = key not in self._series
        ring = self._get(source, name, labels,
                         lambda: SketchSeries(name, labels,
                                              self.ring_samples),
                         SketchSeries)
        if ring is not None:
            if new_series and seed_zero_t is not None:
                # empty cumulative payload at the previous snapshot
                # time — the same birth-seeding rule as counters: a
                # sketch born mid-flight from a known source counts its
                # first burst as the delta it is
                ring.append(seed_zero_t,
                            {"alpha": payload.get("alpha"), "bins": {},
                             "zero": 0, "count": 0, "sum": 0.0,
                             "exemplars": []})
            ring.append(t, payload)
            self._newest[source] = t

    def append_snapshot(self, source: str, snapshot: dict, t: float,
                        families=None) -> int:
        """Append every series of one MetricsRegistry.snapshot()
        document (optionally filtered to `families`); returns series
        appended.  This is the ONE schema bridge between the publisher
        and the store — the round-trip test pins it."""
        appended = 0
        # birth seeding: captured ONCE before any append mutates
        # _newest — a source's FIRST-EVER snapshot must stay a pure
        # baseline (its cumulative values may predate this store), but
        # a series appearing in a LATER snapshot was zero at the
        # previous one
        seed_zero_t = self._newest.get(source)
        for name, entry in snapshot.items():
            if families is not None and name not in families:
                continue
            kind = entry.get("type", "gauge")
            for series in entry.get("series", []):
                labels = series.get("labels", {}) or {}
                if kind == "histogram":
                    bounds = series.get("bounds") or []
                    counts = series.get("counts") or []
                    if bounds and counts:
                        self.append_histogram(source, name, labels, t,
                                              bounds, counts,
                                              seed_zero_t=seed_zero_t)
                        appended += 1
                elif kind == "sketch":
                    if "bins" in series:
                        self.append_sketch(source, name, labels, t,
                                           series,
                                           seed_zero_t=seed_zero_t)
                        appended += 1
                elif "value" in series:
                    self.append_scalar(source, name, labels, t,
                                       series["value"], kind,
                                       seed_zero_t=seed_zero_t)
                    appended += 1
        return appended

    def rings(self, name: str, labels: dict | None = None) -> list:
        """Every ring of one family across all sources whose labels
        are a superset of `labels`: [(source, ring), ...]."""
        out = []
        for (source, ring_name, _), ring in self._series.items():
            if ring_name != name:
                continue
            if labels and any(ring.labels.get(k) != v
                              for k, v in labels.items()):
                continue
            out.append((source, ring))
        return out

    def sources(self) -> list:
        return sorted(self._newest)

    def prune(self, now: float) -> int:
        """Drop every series of sources silent for > 2x the window —
        dead processes under restart churn each left history behind
        under a unique pid topic_path; the store must not grow without
        bound.  Returns series dropped."""
        horizon = now - 2.0 * self.window
        dead = [s for s, t in self._newest.items() if t < horizon]
        if not dead:
            return 0
        dead_set = set(dead)
        victims = [key for key in self._series if key[0] in dead_set]
        for key in victims:
            del self._series[key]
        for source in dead:
            del self._newest[source]
        return len(victims)

    # -- selector-driven reads (SLO rules) ----------------------------------
    def selector_delta(self, selector: str, now: float,
                       window: float) -> float:
        """Summed windowed event delta across every series matching a
        counter/histogram selector (histograms contribute their
        windowed observation count)."""
        name, labels, _ = parse_selector(selector)
        total = 0.0
        for _, ring in self.rings(name, labels):
            if isinstance(ring, HistogramSeries):
                total += ring.delta_count(now, window)
            elif isinstance(ring, SketchSeries):
                delta = ring.delta_sketch(now, window)
                total += delta.count if delta is not None else 0
            else:
                total += max(0.0, ring.delta(now, window))
        return total

    def sketch_window(self, selector: str, now: float, window: float,
                      baseline_empty: bool = False) -> list:
        """Every matching SketchSeries' windowed delta sketch:
        [(source, Sketch), ...] — the ONE reconstruction pass both the
        merged quantile and the exemplar read derive from (a
        continuously breaching rule must not rebuild every source's
        delta twice per evaluation tick)."""
        name, labels, _ = parse_selector(selector)
        out = []
        for source, ring in self.rings(name, labels):
            if not isinstance(ring, SketchSeries):
                continue
            delta = ring.delta_sketch(now, window, baseline_empty)
            if delta is not None:
                out.append((source, delta))
        return out

    def merged_sketch(self, selector: str, now: float,
                      window: float,
                      baseline_empty: bool = False) -> Sketch | None:
        """ONE windowed sketch merging every matching SketchSeries
        across every source — the fleet-true quantile surface:
        merged(A, B) equals one-sketch(A ∪ B) by construction, so
        a level rule over this reads the latency distribution the
        FLEET served, not the worst process's.  None when no source
        has windowed evidence."""
        return merge_sketches(
            delta for _, delta in self.sketch_window(
                selector, now, window, baseline_empty))

    def selector_exemplars(self, selector: str, now: float,
                           window: float, k: int = 8,
                           deltas: list | None = None) -> list:
        """Worst-first windowed exemplars across every matching sketch
        series: [{"trace_id", "value", "source"}, ...] — the trace ids
        a firing alert points at (metrics → traces).  Pass `deltas`
        (a sketch_window result) to reuse an already-built pass."""
        if deltas is None:
            deltas = self.sketch_window(selector, now, window)
        entries = []
        for source, delta in deltas:
            for value, exemplar_id, _seq in delta.worst_exemplars(k):
                entries.append({"trace_id": exemplar_id,
                                "value": value, "source": source})
        entries.sort(key=lambda e: -e["value"])
        # one entry per trace id: the same request may be the worst in
        # several windows/series
        seen, unique = set(), []
        for entry in entries:
            if entry["trace_id"] in seen:
                continue
            seen.add(entry["trace_id"])
            unique.append(entry)
        return unique[:k]

    def selector_level(self, selector: str, now: float, window: float,
                       sketch_deltas: list | None = None):
        """Worst (max) windowed value across matching series: histogram
        selectors read the windowed delta-quantile (default p95),
        scalars the windowed maximum, and SKETCH selectors the
        quantile of the cross-source MERGED windowed sketch (fleet-true
        rather than worst-of).  None = no evidence in window.  Pass
        `sketch_deltas` (a sketch_window result) to reuse an
        already-built reconstruction pass."""
        name, labels, quantile = parse_selector(selector)
        worst = None
        sketch_rings = False
        for _, ring in self.rings(name, labels):
            if isinstance(ring, SketchSeries):
                sketch_rings = True
                continue
            if isinstance(ring, HistogramSeries):
                value = ring.delta_quantile(quantile or 0.95, now,
                                            window)
            else:
                value = ring.maximum(now, window)
            if value is not None and (worst is None or value > worst):
                worst = value
        if sketch_rings or sketch_deltas:
            if sketch_deltas is None:
                sketch_deltas = self.sketch_window(selector, now,
                                                   window)
            merged = merge_sketches(d for _, d in sketch_deltas)
            value = merged.quantile(quantile or 0.95) \
                if merged is not None else None
            if value is not None and (worst is None or value > worst):
                worst = value
        return worst


@dataclass(frozen=True)
class SLORule:
    """One declarative SLO rule (grammar documented in README):

    ratio — error-budget burn over event counters:
        error_rate(w) = bad_delta(w) / (bad_delta(w) + good_delta(w))
        burn(w)       = error_rate(w) / (1 - objective)
      breaches when, for ANY (long, short, threshold) pair in `pairs`,
      burn(long) >= threshold AND burn(short) >= threshold — the
      multi-window discipline: the short window proves it is happening
      NOW, the long window proves it is not a blip.

    level — windowed worst value against a threshold:
        value(w) = worst matching series level (histogram selectors
        read the windowed delta-quantile, e.g. ":p95")
      breaches when value(short) >= threshold with the breach sustained
      `for_seconds` (the aggregator tracks persistence)."""
    name: str
    kind: str                      # "ratio" | "level"
    bad: str = ""                  # ratio: bad-events selector
    good: str = ""                 # ratio: good-events selector
    series: str = ""               # level: value selector
    objective: float = 0.999      # ratio: SLO target (good fraction)
    threshold: float = 0.0         # level: breach threshold
    pairs: tuple = ((300.0, 60.0, 2.0),)  # ratio: (long_s, short_s, burn)
    window: float = 60.0           # level: evidence window
    for_seconds: float = 0.0       # level: required persistence
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("ratio", "level"):
            raise ValueError(f"SLORule kind must be ratio|level, got "
                             f"{self.kind!r}")
        if self.kind == "ratio" and not (self.bad and self.good):
            raise ValueError(f"ratio rule {self.name!r} needs bad= and "
                             f"good= selectors")
        if self.kind == "level" and not self.series:
            raise ValueError(f"level rule {self.name!r} needs series=")
        if self.kind == "ratio" and not 0.0 < self.objective < 1.0:
            raise ValueError(f"ratio rule {self.name!r}: objective must "
                             f"be in (0, 1)")

    def evaluate(self, store: SeriesStore, now: float) -> dict:
        """Instantaneous verdict: {"breaching": bool, ...evidence}.
        Persistence (`for_seconds`) and alert state transitions are the
        aggregator's job, not the rule's — rules stay pure functions of
        the store."""
        if self.kind == "ratio":
            budget = 1.0 - self.objective
            burns = []
            breaching = False
            for long_w, short_w, burn_threshold in self.pairs:
                def burn(window):
                    bad = store.selector_delta(self.bad, now, window)
                    good = store.selector_delta(self.good, now, window)
                    total = bad + good
                    rate = bad / total if total > 0 else 0.0
                    return rate / budget if budget > 0 else 0.0
                long_burn, short_burn = burn(long_w), burn(short_w)
                burns.append({"long_s": long_w, "short_s": short_w,
                              "burn_long": round(long_burn, 4),
                              "burn_short": round(short_burn, 4),
                              "threshold": burn_threshold})
                if long_burn >= burn_threshold and \
                        short_burn >= burn_threshold:
                    breaching = True
            return {"breaching": breaching, "kind": "ratio",
                    "objective": self.objective, "windows": burns}
        # ONE delta-sketch reconstruction per tick: the level read and
        # the exemplar read share it
        deltas = store.sketch_window(self.series, now, self.window)
        value = store.selector_level(self.series, now, self.window,
                                     sketch_deltas=deltas)
        verdict = {"breaching": value is not None and
                   value >= self.threshold,
                   "kind": "level", "value": value,
                   "threshold": self.threshold,
                   "window_s": self.window}
        if verdict["breaching"]:
            # sketch-backed selectors carry the worst windowed
            # exemplars — the trace ids BEHIND the breaching quantile
            # (alert → journeys closed loop); empty for
            # histogram/scalar series, which retain no identities
            exemplars = store.selector_exemplars(self.series, now,
                                                 self.window,
                                                 deltas=deltas)
            if exemplars:
                verdict["exemplars"] = exemplars
        return verdict


class HealthAggregator:
    """Fleet-wide SLO watchdog over the retained metrics snapshots.

    Subscribes {namespace}/+/+/0/metrics (every MetricsPublisher in the
    namespace), appends each document into a SeriesStore, and evaluates
    the SLO rules every `interval` seconds on the runtime's engine —
    deterministic under a VirtualClock like everything else.  Alert
    records publish RETAINED on {namespace}/alert/{rule}, so a
    late-joining Dashboard or Recorder still sees the current state;
    `on_alert` callbacks fire on the inactive→firing TRANSITION only
    (the flight-recorder dump trigger rides this — every breach ships
    one postmortem, not one per evaluation tick)."""

    def __init__(self, runtime, rules=(), interval: float = 1.0,
                 window: float = 300.0, name: str = "health",
                 store: SeriesStore | None = None,
                 topic_filter: str | None = None,
                 families=None, retain_alerts: bool = True,
                 registry: MetricsRegistry | None = None):
        self.runtime = runtime
        self.name = name
        self.rules = list(rules)
        self.store = store or SeriesStore(window=window)
        self.families = set(families) if families is not None else None
        self.retain_alerts = retain_alerts
        self.logger = get_logger(f"health.{name}")
        self.on_alert: list = []          # callbacks (rule, record)
        self.alerts: dict[str, dict] = {}     # rule name -> last record
        self.fired: dict[str, int] = {}   # rule name -> firing count
        # rule name -> {"breach_since": t|None, "firing": bool}
        self._state: dict[str, dict] = {
            rule.name: {"breach_since": None, "firing": False}
            for rule in self.rules}
        self._filter = topic_filter or \
            f"{runtime.namespace}/+/+/{METRICS_TOPIC_SUFFIX}"
        self._registry = registry or default_registry()
        labels = {"aggregator": name}
        self._snapshots_seen = self._registry.counter(
            "health_snapshots_total",
            "metrics snapshots ingested by the aggregator", labels)
        self._alert_counters: dict = {}
        self._labels = labels
        runtime.add_message_handler(self._metrics_handler, self._filter)
        self._timer = runtime.event.add_timer_handler(self.evaluate,
                                                      float(interval))

    # -- intake -------------------------------------------------------------
    def _metrics_handler(self, topic: str, payload) -> None:
        document = parse_retained_json(payload, require_key="snapshot")
        if document is None:
            self.logger.debug("health %s: unparseable snapshot on %s",
                              self.name, topic)
            return
        source = str(document.get("topic_path", topic))
        # stamped on the RECEIVER's clock: windowed reads compare
        # against this engine's now(), and cross-machine publisher
        # clocks are not assumed comparable (same rule as tracing's
        # deadline re-anchor)
        now = self.runtime.event.clock.now()
        self.store.append_snapshot(source, document["snapshot"], now,
                                   families=self.families)
        self._snapshots_seen.inc()

    # -- evaluation ---------------------------------------------------------
    def _count_alert(self, rule_name: str, state: str) -> None:
        key = (rule_name, state)
        counter = self._alert_counters.get(key)
        if counter is None:
            counter = self._registry.counter(
                "health_alerts_total",
                "SLO alert transitions by rule and state",
                labels={**self._labels, "rule": rule_name,
                        "state": state})
            self._alert_counters[key] = counter
        counter.inc()

    def _publish_alert(self, record: dict) -> None:
        topic = f"{self.runtime.namespace}/{ALERT_TOPIC_PREFIX}/" \
                f"{record['rule']}"
        try:
            self.runtime.publish(topic, json.dumps(record, default=str),
                                 retain=self.retain_alerts)
        except Exception:
            self.logger.exception("health %s: alert publish failed",
                                  self.name)

    def evaluate(self) -> None:
        """One evaluation tick (engine timer): every rule against the
        store, persistence tracking, state transitions, retained alert
        records."""
        now = self.runtime.event.clock.now()
        self.store.prune(now)
        for rule in self.rules:
            # keyed by the aggregator's fixed rule set — bounded:
            # graft: disable=lint-unbounded-cache
            state = self._state.setdefault(
                rule.name, {"breach_since": None, "firing": False})
            try:
                verdict = rule.evaluate(self.store, now)
            except Exception:
                self.logger.exception("health %s: rule %s evaluation "
                                      "failed", self.name, rule.name)
                continue
            if verdict["breaching"]:
                if state["breach_since"] is None:
                    state["breach_since"] = now
                sustained = now - state["breach_since"] >= \
                    rule.for_seconds
                if sustained and not state["firing"]:
                    state["firing"] = True
                    record = {
                        "rule": rule.name, "state": "firing",
                        "since": state["breach_since"], "time": now,
                        "description": rule.description,
                        "detail": verdict,
                        # exemplar trace ids hoisted top-level so every
                        # consumer (Recorder, DumpOnAlert, an operator
                        # reading the retained record) finds them
                        # without knowing the verdict schema
                        "exemplars": [e["trace_id"] for e in
                                      verdict.get("exemplars", [])],
                    }
                    # graft: disable=lint-unbounded-cache
                    self.alerts[rule.name] = record
                    # graft: disable=lint-unbounded-cache (rule set)
                    self.fired[rule.name] = \
                        self.fired.get(rule.name, 0) + 1
                    self._count_alert(rule.name, "firing")
                    self._publish_alert(record)
                    self.logger.warning(
                        "SLO alert FIRING: %s (%s)", rule.name,
                        rule.description or rule.kind)
                    for callback in list(self.on_alert):
                        try:
                            callback(rule, record)
                        except Exception:
                            self.logger.exception(
                                "health %s: on_alert callback failed",
                                self.name)
            else:
                state["breach_since"] = None
                if state["firing"]:
                    state["firing"] = False
                    record = {"rule": rule.name, "state": "resolved",
                              "time": now,
                              "description": rule.description,
                              "detail": verdict}
                    # graft: disable=lint-unbounded-cache
                    self.alerts[rule.name] = record
                    self._count_alert(rule.name, "resolved")
                    self._publish_alert(record)
                    self.logger.warning("SLO alert resolved: %s",
                                        rule.name)

    def firing(self) -> list:
        """Names of rules currently in the firing state."""
        return sorted(name for name, state in self._state.items()
                      if state["firing"])

    def stop(self) -> None:
        if self._timer is not None:
            self.runtime.event.remove_timer_handler(self._timer)
            self._timer = None
        self.runtime.remove_message_handler(self._metrics_handler,
                                            self._filter)
