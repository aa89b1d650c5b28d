# Metrics registry: process-wide counters, gauges, histograms and
# sketches.
#
# The port's own copy of aiko_services_tpu/observe/metrics.py: counters,
# gauges, fixed-bucket histograms (the event engine's handler latency),
# mergeable quantile sketches (observe/sketch.py: the decoder's TTFT and
# ITL families), the registry that names them and snapshots them as plain
# data, and MirroredStats (a stats dict whose increments mirror into a
# counter family).  Metric names are the JAX package's, so dashboards read
# both packages alike.

from __future__ import annotations

from ..utils.lock import Lock
from .sketch import Sketch

__all__ = ["Counter", "Gauge", "Histogram", "Sketch", "MetricsRegistry",
           "MirroredStats", "default_registry", "log_buckets",
           "DEFAULT_LATENCY_BUCKETS"]


def log_buckets(start: float, factor: float, count: int) -> tuple:
    """`count` log-spaced bucket upper bounds: start, start*factor, ..."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("log_buckets wants start>0, factor>1, count>=1")
    bounds, value = [], float(start)
    for _ in range(count):
        bounds.append(value)
        value *= factor
    return tuple(bounds)


# 0.1 ms .. ~52 s in powers of two: one bucket family resolves an event
# handler and a first-call device build alike.
DEFAULT_LATENCY_BUCKETS = log_buckets(0.0001, 2.0, 20)


class Counter:
    """Monotonic counter.  inc() is the lock-free hot path."""
    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._value = 0

    def inc(self, amount=1) -> None:
        self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """Settable level; inc/dec for occupancy-style use."""
    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._value = 0

    def set(self, value) -> None:
        self._value = value

    def inc(self, amount=1) -> None:
        self._value += amount

    def dec(self, amount=1) -> None:
        self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram.  observe() is the lock-free hot path: a
    linear scan over ~20 log-spaced bounds plus two slot adds."""
    __slots__ = ("name", "labels", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, labels: dict, buckets=None):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in
                            (buckets or DEFAULT_LATENCY_BUCKETS))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {name}: buckets must ascend")
        # counts[i] = observations <= bounds[i] exclusive of earlier
        # buckets; counts[-1] = overflow (> bounds[-1])
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value) -> None:
        index = 0
        for bound in self.bounds:
            if value <= bound:
                break
            index += 1
        self.counts[index] += 1
        self.sum += value
        self.count += 1


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "sketch": Sketch}


class MetricsRegistry:
    """Process-wide metric table: get-or-create by (name, labels)."""

    def __init__(self):
        # held only for metric creation, never per record
        self._lock = Lock("observe.registry")
        self._metrics: dict[tuple, object] = {}
        self._types: dict[str, str] = {}
        self._help: dict[str, str] = {}

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _get_or_create(self, kind: str, name: str, help_text: str,
                       labels: dict | None, **kwargs):
        key = self._key(name, labels)
        with self._lock:
            registered = self._types.get(name)
            if registered is not None and registered != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{registered}, requested {kind}")
            metric = self._metrics.get(key)
            if metric is None:
                metric = _KINDS[kind](name, dict(labels or {}), **kwargs)
                self._types[name] = kind
                self._metrics[key] = metric
                if help_text:
                    self._help[name] = help_text
            return metric

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None, buckets=None) -> Histogram:
        return self._get_or_create("histogram", name, help, labels,
                                   buckets=buckets)

    def sketch(self, name: str, help: str = "",
               labels: dict | None = None, **kwargs) -> Sketch:
        """Mergeable quantile sketch (observe/sketch.py): relative-error
        quantiles that merge across processes, with the worst requests'
        trace ids as exemplars."""
        return self._get_or_create("sketch", name, help, labels,
                                   **kwargs)

    def series(self, name: str) -> list:
        """Every live series of one metric family, whatever its labels:
        [(labels_dict, metric), ...] (the admission gate's
        batch_mean_wait_ms fallback reads the family this way)."""
        with self._lock:
            return [(dict(metric.labels), metric)
                    for (metric_name, _), metric in self._metrics.items()
                    if metric_name == name]

    def value(self, name: str, labels: dict | None = None, default=0):
        """Read one series' current value without creating it: a
        counter's or gauge's value, a histogram's count."""
        metric = self._metrics.get(self._key(name, labels))
        if metric is None:
            return default
        return metric.count if isinstance(metric, Histogram) \
            else metric.value

    def snapshot(self) -> dict:
        """Plain-data view of every series, JSON-able:
        {name: {"type", "help", "series": [{"labels", ...values}]}}."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for (name, _), metric in items:
            entry = out.setdefault(name, {
                "type": self._types[name],
                "help": self._help.get(name, ""),
                "series": [],
            })
            labels = dict(metric.labels)
            if isinstance(metric, Histogram):
                entry["series"].append({
                    "labels": labels, "bounds": list(metric.bounds),
                    "counts": list(metric.counts),
                    "sum": metric.sum, "count": metric.count})
            elif isinstance(metric, Sketch):
                entry["series"].append({"labels": labels,
                                        **metric.to_dict()})
            else:
                entry["series"].append({"labels": labels,
                                        "value": metric.value})
        return out


class MirroredStats(dict):
    """A stats dict whose numeric increments mirror into a registry
    counter family: `stats[k] += n` updates the dict AND
    `metric{label=k, **labels}`.  Missing keys read as 0; only positive
    numeric deltas mirror; keys in `skip` (levels, time sums) never
    mirror."""

    def __init__(self, initial=None, metric: str = "", help: str = "",
                 label: str = "kind", labels: dict | None = None,
                 registry: MetricsRegistry | None = None, skip=()):
        super().__init__(initial or {})
        self._metric = metric
        self._help = help
        self._label = label
        self._labels = dict(labels or {})
        self._registry = registry
        self._counters: dict = {}
        self._skip = frozenset(skip)

    def __missing__(self, key):
        return 0

    def _counter(self, key) -> Counter:
        counter = self._counters.get(key)
        if counter is None:
            registry = self._registry or default_registry()
            counter = registry.counter(
                self._metric, self._help,
                labels={**self._labels, self._label: str(key)})
            self._counters[key] = counter
        return counter

    def __setitem__(self, key, value) -> None:
        if self._metric and key not in self._skip \
                and isinstance(value, (int, float)) \
                and not isinstance(value, bool):
            old = self.get(key, 0)
            if isinstance(old, (int, float)):
                delta = value - old
                if delta > 0:
                    self._counter(key).inc(delta)
        super().__setitem__(key, value)


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry
