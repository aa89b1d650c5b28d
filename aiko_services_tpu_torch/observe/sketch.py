# Mergeable quantile sketches.
#
# The port's own copy of aiko_services_tpu/observe/sketch.py: a
# DDSketch-style relative-error sketch (Masson et al., VLDB'19).  Values
# land in logarithmic buckets index = ceil(log_gamma(v)) with gamma =
# (1 + alpha) / (1 - alpha), so every quantile is within relative error
# alpha of the sample quantile; two sketches of one gamma merge exactly by
# adding bucket counts; the bucket map is bounded (past max_bins the
# lowest buckets collapse); each sketch keeps a top-k ring of its worst
# exemplars (value, trace id, seq).  The buckets, quantiles and the
# to_dict form are the JAX package's byte for byte, so
# scripts/slo_report.py and the dashboard merge both packages' sketches.
# observe() is lock-free, like the rest of the registry.

from __future__ import annotations

import math

__all__ = ["Sketch", "DEFAULT_ALPHA", "DEFAULT_EXEMPLAR_K",
           "merge_sketches"]

DEFAULT_ALPHA = 0.01          # 1% relative error per quantile
DEFAULT_EXEMPLAR_K = 4        # worst exemplars retained per sketch
DEFAULT_MAX_BINS = 2048       # bucket-map bound before collapsing
_MIN_TRACKABLE = 1e-9         # values at/below this land in the zero bin


class Sketch:
    """DDSketch-style relative-error quantile sketch with exemplars.

    Registry-compatible (name/labels like Counter/Gauge/Histogram so
    MetricsRegistry can own instances), but also usable bare — the
    series store builds throwaway delta sketches from snapshot pairs.
    """

    __slots__ = ("name", "labels", "alpha", "gamma", "_log_gamma",
                 "max_bins", "exemplar_k", "bins", "zero", "count",
                 "sum", "exemplars")

    def __init__(self, name: str = "", labels: dict | None = None,
                 alpha: float = DEFAULT_ALPHA,
                 max_bins: int = DEFAULT_MAX_BINS,
                 exemplar_k: int = DEFAULT_EXEMPLAR_K):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"sketch alpha must be in (0, 1), got "
                             f"{alpha}")
        self.name = name
        self.labels = dict(labels or {})
        self.alpha = float(alpha)
        self.gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_bins = int(max_bins)
        self.exemplar_k = int(exemplar_k)
        self.bins: dict[int, int] = {}
        self.zero = 0                 # observations <= _MIN_TRACKABLE
        self.count = 0
        self.sum = 0.0
        # [value, exemplar_id, seq] — kept sorted is not worth it at
        # k=4; linear min-scan on replacement
        self.exemplars: list = []

    # -- recording (hot path) ------------------------------------------------
    def observe(self, value, exemplar: str | None = None) -> None:
        value = float(value)
        if value <= _MIN_TRACKABLE:
            self.zero += 1
        else:
            index = math.ceil(math.log(value) / self._log_gamma)
            self.bins[index] = self.bins.get(index, 0) + 1
            if len(self.bins) > self.max_bins:
                self._collapse()
        self.count += 1
        self.sum += value
        if exemplar:
            self._note_exemplar(value, str(exemplar))

    def _note_exemplar(self, value: float, exemplar_id: str) -> None:
        entries = self.exemplars
        if len(entries) < self.exemplar_k:
            entries.append([value, exemplar_id, self.count])
            return
        worst_index, worst_value = 0, entries[0][0]
        for i in range(1, len(entries)):
            if entries[i][0] < worst_value:
                worst_index, worst_value = i, entries[i][0]
        if value > worst_value:
            entries[worst_index] = [value, exemplar_id, self.count]

    def _collapse(self) -> None:
        """Fold the lowest buckets together until the map fits the
        bound — only quantiles below the collapsed mass lose accuracy;
        the tail (what SLO rules read) keeps its alpha guarantee."""
        while len(self.bins) > self.max_bins:
            lowest, second = sorted(self.bins)[:2]
            self.bins[second] = self.bins.get(second, 0) + \
                self.bins.pop(lowest)

    def clear(self) -> None:
        """Drop every observation and exemplar (bench warmup boundary;
        production readers take windowed deltas instead)."""
        self.bins.clear()
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.exemplars = []

    # -- reading -------------------------------------------------------------
    def quantile(self, q: float):
        """The q-quantile (0..1) within relative error alpha, or None
        on an empty sketch (no evidence ≠ zero latency)."""
        if self.count <= 0:
            return None
        # dict(self.bins) is one C-level (GIL-atomic) copy: unlike
        # Histogram's fixed-length counts list, the bin map GROWS on
        # the lock-free observe() path, and a Python-level iteration
        # racing an insert raises "dictionary changed size" — the
        # registry's best-effort concurrency rule requires reads to
        # tolerate concurrent writers, not crash on them
        bins = dict(self.bins)
        rank = q * (self.count - 1)
        running = self.zero
        if running > rank:
            return 0.0
        for index in sorted(bins):
            running += bins[index]
            if running > rank:
                return 2.0 * self.gamma ** index / (self.gamma + 1.0)
        return 0.0 if not bins else \
            2.0 * self.gamma ** max(bins) / (self.gamma + 1.0)

    @property
    def value(self):
        """Registry-surface compatibility (MetricsRegistry.value)."""
        return self.count

    def worst_exemplars(self, k: int | None = None,
                        min_seq: int = 0) -> list:
        """Top-k exemplars by value, worst first, restricted to those
        observed AFTER the sketch's count was `min_seq` — the windowed
        read: a reader holding the window-start count filters without
        any cross-process clock."""
        entries = [e for e in self.exemplars if e[2] > min_seq]
        entries.sort(key=lambda e: -e[0])
        return entries[:k if k is not None else self.exemplar_k]

    # -- merge ---------------------------------------------------------------
    def merge(self, other: "Sketch") -> "Sketch":
        """Add `other`'s mass into this sketch (in place; returns self).
        Exact: merged bins equal the bins of one sketch fed both
        streams, so quantiles agree to the bit.  Exemplar seqs lose
        their per-source meaning after a merge — merged sketches are
        read-side artifacts, filter windows BEFORE merging."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different gamma "
                f"({self.gamma} vs {other.gamma}): re-bucketing would "
                f"break the relative-error guarantee")
        for index, bucket_count in other.bins.items():
            self.bins[index] = self.bins.get(index, 0) + bucket_count
        if len(self.bins) > self.max_bins:
            self._collapse()
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        for value, exemplar_id, _ in other.exemplars:
            self._note_exemplar(value, exemplar_id)
        return self

    # -- wire form -----------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-able snapshot payload (bin keys become strings — JSON
        has no int keys; from_dict restores them).  The bin map and
        exemplar list are captured with GIL-atomic copies first so a
        concurrent lock-free observe() cannot blow up a registry
        snapshot mid-iteration (see quantile)."""
        bins = dict(self.bins)
        exemplars = list(self.exemplars)
        return {
            "alpha": self.alpha,
            "bins": {str(k): v for k, v in bins.items()},
            "zero": self.zero,
            "count": self.count,
            "sum": self.sum,
            "exemplars": [list(e) for e in exemplars],
        }

    @classmethod
    def from_dict(cls, payload: dict, name: str = "",
                  labels: dict | None = None) -> "Sketch | None":
        """Inverse of to_dict; tolerant of malformed input (a bad
        retained snapshot must never fail a subscriber)."""
        try:
            sketch = cls(name, labels,
                         alpha=float(payload.get("alpha",
                                                 DEFAULT_ALPHA)))
            sketch.bins = {int(k): int(v)
                           for k, v in (payload.get("bins") or
                                        {}).items()}
            sketch.zero = int(payload.get("zero", 0))
            sketch.count = int(payload.get("count", 0))
            sketch.sum = float(payload.get("sum", 0.0))
            sketch.exemplars = [
                [float(e[0]), str(e[1]), int(e[2])]
                for e in (payload.get("exemplars") or [])
                if isinstance(e, (list, tuple)) and len(e) >= 3]
            return sketch
        except (TypeError, ValueError, AttributeError):
            return None


def merge_sketches(sketches) -> Sketch | None:
    """Merge an iterable of sketches into a fresh one (None when the
    iterable is empty) — the fleet-read helper: per-source windowed
    delta sketches in, one fleet-true quantile surface out.

    Sketches whose gamma differs from the first one's are SKIPPED, not
    raised on: the inputs come from network-received snapshots, and a
    foreign/cross-version publisher shipping a different alpha must
    not wedge every Autoscaler.evaluate tick or SLO-rule evaluation
    (the same robustness rule as SeriesStore's stale-kind ring
    replacement)."""
    merged = None
    for sketch in sketches:
        if sketch is None:
            continue
        if merged is None:
            merged = Sketch(sketch.name, sketch.labels,
                            alpha=sketch.alpha,
                            exemplar_k=max(DEFAULT_EXEMPLAR_K,
                                           sketch.exemplar_k))
            merged.merge(sketch)
        elif abs(sketch.gamma - merged.gamma) <= 1e-12:
            merged.merge(sketch)
        # else: incompatible alpha from a foreign publisher — skip
    return merged
