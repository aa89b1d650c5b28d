# Continuous batching: many streams, one device, bounded latency.
#
# The port's own copy of aiko_services_tpu/ops/batching.py (host code,
# no device work): frames from many streams accumulate in per-bucket
# queues keyed by padded shape; the scheduler drains a full batch as soon
# as (a) the batch is full, (b) the oldest frame has waited max_wait, or
# (c) waiting longer would miss the earliest completion deadline.  Shape
# bucketing bounds the number of distinct shapes a program sees.
# attach() drives drain() from an event engine's timer.  The wait estimate
# (estimated_wait, service_estimate, next_deadline, pending) is what an
# admission gate (ops/admission.py) sheds on.  The dispatch gate and the
# pipelined results path wait for ROADMAP.md Queue 1 item 2.

from __future__ import annotations

import bisect
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..utils.lock import Lock

__all__ = ["BatchItem", "BatchingScheduler", "ShapeBuckets"]


class ShapeBuckets:
    """Monotone bucket ladder: a length is padded up to the next bucket so
    only len(buckets) shapes ever reach the compiler."""

    def __init__(self, buckets):
        self.buckets = sorted(buckets)

    def bucket_for(self, length: int) -> int:
        index = bisect.bisect_left(self.buckets, length)
        if index == len(self.buckets):
            raise ValueError(
                f"length {length} exceeds largest bucket "
                f"{self.buckets[-1]}")
        return self.buckets[index]


@dataclass
class BatchItem:
    stream_id: str
    payload: Any
    enqueue_time: float
    callback: Callable          # callback(stream_id, result)
    bucket: int = 0
    deadline: float | None = None   # absolute completion target


@dataclass
class _Bucket:
    items: deque = field(default_factory=deque)


class BatchingScheduler:
    """Arrival-driven batch former.

    process_batch(bucket, items) -> list[result] is called on the
    scheduler's drive thread (or the caller of drain() in inline mode)
    with at most max_batch items of one bucket; results fan back out
    through each item's callback.  Latency contract: an item waits at most
    max_wait before its (possibly partial) batch is dispatched.
    """

    def __init__(self, process_batch, buckets: ShapeBuckets,
                 max_batch: int = 32, max_wait: float = 0.05,
                 clock=time.monotonic, metrics_labels: dict | None = None):
        self.process_batch = process_batch
        self.buckets = buckets
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.clock = clock
        self._lock = Lock("batching.scheduler")
        self._queues: dict[int, _Bucket] = {}
        # EWMA of recent per-batch service time (dispatch → results),
        # fed back by the owner via observe_service_time(): the
        # deadline-at-risk test needs to know how long a batch takes
        self._service_ewma: dict[int, float] = {}
        # cumulative counters, mirrored onto the process metrics
        # registry (batch_scheduler_total{kind=...}); metrics_labels
        # (e.g. {"program": name}) separates schedulers per series
        from ..observe.metrics import MirroredStats
        self.stats = MirroredStats(
            {"batches": 0, "items": 0, "batch_size_sum": 0,
             "full_batches": 0, "wait_sum": 0.0,
             "deadline_dispatches": 0},
            metric="batch_scheduler_total",
            help="continuous-batching scheduler events by kind",
            labels=metrics_labels,
            # sums are levels, not events: dict-only
            skip=("batch_size_sum", "wait_sum"))
        # rolling queue-wait samples (seconds) for percentile reporting
        self.recent_waits: deque = deque(maxlen=4096)

    def submit(self, stream_id: str, payload, length: int,
               callback, deadline: float | None = None) -> None:
        """Enqueue one item.  `deadline` (absolute, scheduler clock) is
        the item's completion target: the batch former dispatches a
        partial batch EARLY when waiting longer would make the earliest
        deadline unmeetable, instead of sitting out the full max_wait."""
        bucket = self.buckets.bucket_for(length)
        item = BatchItem(stream_id, payload, self.clock(), callback,
                         bucket, deadline)
        with self._lock:
            self._queues.setdefault(bucket, _Bucket()).items.append(item)

    def observe_service_time(self, bucket: int, seconds: float) -> None:
        """Feed back a measured batch service time (dispatch → results
        delivered) so deadline-at-risk admission has a current
        estimate.  EWMA, alpha=0.3."""
        with self._lock:
            prior = self._service_ewma.get(bucket)
            self._service_ewma[bucket] = seconds if prior is None \
                else 0.7 * prior + 0.3 * seconds

    def service_estimate(self, bucket: int) -> float | None:
        with self._lock:
            return self._service_ewma.get(bucket)

    def estimated_wait(self, bucket_key: int | None = None,
                       extra: int = 1) -> float | None:
        """Expected queue wait for the NEXT `extra` item(s) submitted to
        `bucket_key` (None = worst case over every non-empty bucket):
        batch-forming delay plus the service time of every batch ahead
        of — and including — the one the item would join.

            wait ≈ forming_delay + ceil((occupancy + extra) / max_batch)
                   × service_ewma

        forming_delay is the head item's remaining max_wait share; it
        collapses to 0 once the joining batch would be full.  With no
        service EWMA yet (cold scheduler) the observed mean queue wait
        substitutes, and a scheduler that has never dispatched returns
        None: an admission gate must not shed on a number it does not
        have."""
        now = self.clock()
        with self._lock:
            if bucket_key is None:
                keys = [k for k, b in self._queues.items() if b.items]
                if not keys:
                    keys = list(self._service_ewma)
                if not keys:
                    return self.mean_wait() if self.stats["items"] \
                        else None
                return max(
                    (w for w in (self._estimate_locked(k, extra, now)
                                 for k in keys) if w is not None),
                    default=None)
            return self._estimate_locked(bucket_key, extra, now)

    def _estimate_locked(self, bucket_key: int, extra: int,
                         now: float) -> float | None:
        bucket = self._queues.get(bucket_key)
        occupancy = len(bucket.items) if bucket is not None else 0
        estimate = self._service_ewma.get(bucket_key)
        if estimate is None:
            # cold bucket: the scheduler-wide mean wait is the only
            # signal there is
            return self.mean_wait() if self.stats["items"] else None
        joining = occupancy + max(1, extra)
        if joining >= self.max_batch:
            forming = 0.0
        elif bucket is not None and bucket.items:
            head_age = now - bucket.items[0].enqueue_time
            forming = max(0.0, self.max_wait - head_age)
        else:
            forming = self.max_wait
        batches_ahead = -(-joining // self.max_batch)   # ceil division
        return forming + batches_ahead * estimate

    def _deadline_at_risk(self, bucket_key: int, bucket: _Bucket,
                          now: float) -> bool:
        """True when waiting any longer would likely miss the earliest
        deadline in this bucket: remaining slack has shrunk to the
        estimated service time."""
        estimate = self._service_ewma.get(bucket_key)
        if estimate is None:
            return False
        earliest = min((i.deadline for i in bucket.items
                        if i.deadline is not None), default=None)
        return earliest is not None and earliest - now <= estimate

    def _ready_bucket(self, now: float):
        """A bucket is ready when full, its head item is older than
        max_wait, or its earliest deadline is at risk.  Oldest head
        wins (FIFO fairness across buckets).  Returns
        (bucket_key, deadline_driven) or None."""
        best, best_age = None, -1.0
        for bucket_key, bucket in self._queues.items():
            if not bucket.items:
                continue
            age = now - bucket.items[0].enqueue_time
            if len(bucket.items) >= self.max_batch:
                age += 1e6          # full batch: dispatch first
            if age > best_age:
                best, best_age = bucket_key, age
        if best is None:
            return None
        bucket = self._queues[best]
        if len(bucket.items) >= self.max_batch or \
                best_age >= self.max_wait:
            return best, False
        # the at-risk test must cover EVERY bucket, not just the one
        # with the oldest head — a younger bucket can hold the tighter
        # deadline
        for bucket_key, bucket in self._queues.items():
            if bucket.items and self._deadline_at_risk(bucket_key,
                                                       bucket, now):
                return bucket_key, True
        return None

    def next_deadline(self) -> float | None:
        """When the next dispatch is due: now for an already-full bucket,
        else the sooner of (oldest item's max_wait expiry, the moment
        the earliest completion deadline becomes at-risk)."""
        with self._lock:
            dues = []
            for bucket_key, bucket in self._queues.items():
                if not bucket.items:
                    continue
                if len(bucket.items) >= self.max_batch:
                    return self.clock()        # dispatchable right now
                due = bucket.items[0].enqueue_time + self.max_wait
                estimate = self._service_ewma.get(bucket_key)
                if estimate is not None:
                    earliest = min((i.deadline for i in bucket.items
                                    if i.deadline is not None),
                                   default=None)
                    if earliest is not None:
                        due = min(due, earliest - estimate)
                dues.append(due)
        return min(dues) if dues else None

    def pending(self) -> int:
        with self._lock:
            return sum(len(b.items) for b in self._queues.values())

    def drain(self, force: bool = False) -> int:
        """Dispatch ready batches; force=True flushes everything.  Returns
        the number of items processed."""
        processed = 0
        while True:
            now = self.clock()
            with self._lock:
                ready = self._ready_bucket(now)
                deadline_driven = False
                if ready is not None:
                    bucket_key, deadline_driven = ready
                elif force:
                    nonempty = [k for k, b in self._queues.items()
                                if b.items]
                    bucket_key = nonempty[0] if nonempty else None
                else:
                    bucket_key = None
                if bucket_key is None:
                    return processed
                if deadline_driven:
                    self.stats["deadline_dispatches"] += 1
                queue = self._queues[bucket_key].items
                batch = [queue.popleft()
                         for _ in range(min(self.max_batch, len(queue)))]
            # items are already popped: every callback MUST fire, or the
            # stream's frame silently vanishes — errors fan out as results.
            try:
                results = self.process_batch(bucket_key, batch)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"process_batch returned {len(results)} results "
                        f"for {len(batch)} items")
            except Exception as exc:
                results = [exc] * len(batch)
            self.stats["batches"] += 1
            self.stats["items"] += len(batch)
            self.stats["batch_size_sum"] += len(batch)
            self.stats["full_batches"] += \
                int(len(batch) >= self.max_batch)
            waits = [now - i.enqueue_time for i in batch]
            self.stats["wait_sum"] += sum(waits)
            self.recent_waits.extend(waits)
            for item, result in zip(batch, results):
                item.callback(item.stream_id, result)
            processed += len(batch)

    def attach(self, engine, period: float = 0.005) -> int:
        """Drive from an EventEngine: a fast timer checks deadlines and
        drains ready batches (control plane integration)."""
        return engine.add_timer_handler(lambda: self.drain(), period)

    def mean_batch_size(self) -> float:
        batches = self.stats["batches"]
        return self.stats["batch_size_sum"] / batches if batches else 0.0

    def mean_wait(self) -> float:
        items = self.stats["items"]
        return self.stats["wait_sum"] / items if items else 0.0
