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
# admission gate (ops/admission.py) sheds on.  A dispatch gate bounds how
# many batches the pipelined results path (compute.py) has in flight.
#
# On a mesh (one rank included) every rank runs the same batches, whose
# collectives pair up across the ranks: the batch cut is agreed
# (agreed=True, driven by ComputeRuntime's one agreement per drive tick).
# Each item is named by its stream id and a per-stream sequence number,
# never by its arrival time; every rank offers the items it holds (note),
# rank 0 adds the cuts its clock and estimates decide, and every rank
# dispatches, in rank 0's order, the items of those cuts that every rank
# holds (apply_note).  An item some rank does not hold yet waits; one
# whose content differs between ranks raises.

from __future__ import annotations

import bisect
import hashlib
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
    key: tuple = ()                 # (stream id, per-stream sequence)
    digest: str = ""                # agreed: the payload's content


def _payload_digest(payload, length: int, deadline) -> str:
    """What the ranks compare of one item: its host payload's bytes (an
    array's dtype, shape and data; a card tensor's dtype and shape, which
    reading would synchronize), its length and its deadline's presence."""
    digest = hashlib.sha256(repr((int(length),
                                  deadline is None)).encode())
    data = getattr(payload, "numpy", None)
    if getattr(payload, "device", None) is not None and \
            getattr(payload.device, "type", "cpu") != "cpu":
        digest.update(repr((str(payload.dtype),
                            tuple(payload.shape))).encode())
    elif data is not None or hasattr(payload, "tobytes"):
        array = payload.numpy() if data is not None else payload
        digest.update(repr((str(array.dtype), array.shape)).encode())
        digest.update(array.tobytes())
    else:
        digest.update(repr(payload).encode())
    return digest.hexdigest()[:16]


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
                 clock=time.monotonic, dispatch_gate=None,
                 metrics_labels: dict | None = None,
                 agreed: bool = False, dispatch_room=None):
        self.process_batch = process_batch
        self.buckets = buckets
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.clock = clock
        # dispatch_gate() -> bool: when False, drain stops dispatching
        # (the pipelined path bounds how many batches are in flight on
        # the device at once)
        self.dispatch_gate = dispatch_gate
        # agreed (on a mesh): drain() cuts nothing by this rank's clock;
        # note() / apply_note() form the batches every rank runs, and
        # dispatch_room() -> int (the pipelined path's free in-flight
        # places, None: unbounded) is what each rank offers
        self.agreed = bool(agreed)
        self.dispatch_room = dispatch_room
        self._sequence: dict[str, int] = {}
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
             "gated": 0, "deadline_dispatches": 0},
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
            if self.agreed:
                number = self._sequence.get(stream_id, 0)
                self._sequence[stream_id] = number + 1
                item.key = (str(stream_id), number)
                item.digest = _payload_digest(payload, length, deadline)
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

    def _deadline_at_risk(self, bucket_key: int, items,
                          now: float) -> bool:
        """True when waiting any longer would likely miss the earliest
        deadline in this bucket: remaining slack has shrunk to the
        estimated service time."""
        estimate = self._service_ewma.get(bucket_key)
        if estimate is None:
            return False
        earliest = min((i.deadline for i in items
                        if i.deadline is not None), default=None)
        return earliest is not None and earliest - now <= estimate

    def _ready_bucket(self, now: float, queues=None):
        """A bucket is ready when full, its head item is older than
        max_wait, or its earliest deadline is at risk.  Oldest head
        wins (FIFO fairness across buckets).  `queues` (bucket -> its
        items) defaults to the live queues.  Returns
        (bucket_key, deadline_driven) or None."""
        if queues is None:
            queues = {key: bucket.items
                      for key, bucket in self._queues.items()}
        best, best_age = None, -1.0
        for bucket_key, items in queues.items():
            if not items:
                continue
            age = now - items[0].enqueue_time
            if len(items) >= self.max_batch:
                age += 1e6          # full batch: dispatch first
            if age > best_age:
                best, best_age = bucket_key, age
        if best is None:
            return None
        if len(queues[best]) >= self.max_batch or \
                best_age >= self.max_wait:
            return best, False
        # the at-risk test must cover EVERY bucket, not just the one
        # with the oldest head — a younger bucket can hold the tighter
        # deadline
        for bucket_key, items in queues.items():
            if items and self._deadline_at_risk(bucket_key, items, now):
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
        the number of items processed.  Agreed: only force dispatches
        here (a sync caller's own item, or teardown); the timed cuts
        come from apply_note."""
        if self.agreed and not force:
            return 0
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
                # force (teardown) bypasses the gate: every queued item
                # must reach its callback even over-depth
                if not force and self.dispatch_gate is not None and \
                        not self.dispatch_gate():
                    self.stats["gated"] += 1
                    return processed
                if deadline_driven:
                    self.stats["deadline_dispatches"] += 1
                queue = self._queues[bucket_key].items
                batch = [queue.popleft()
                         for _ in range(min(self.max_batch, len(queue)))]
            self._dispatch(bucket_key, batch, now)
            processed += len(batch)

    # -- the agreed cut (on a mesh) ------------------------------------------
    def note(self, lead: bool) -> dict | None:
        """This rank's part of one agreement: the items it holds (key,
        digest) and its dispatch room; rank 0 (`lead`) adds its cuts,
        the batches its clock and estimates make ready now (drain's
        rule, run on a copy of its queues), each (bucket, deadline
        driven, keys in order).  None when nothing is queued."""
        now = self.clock()
        with self._lock:
            queues = {key: list(bucket.items)
                      for key, bucket in self._queues.items()
                      if bucket.items}
            if not queues:
                return None
            mine = {"held": [(item.key, item.digest)
                             for items in queues.values()
                             for item in items],
                    "room": None if self.dispatch_room is None
                    else int(self.dispatch_room())}
            if lead:
                cuts = []
                while True:
                    ready = self._ready_bucket(now, queues)
                    if ready is None:
                        break
                    bucket_key, deadline_driven = ready
                    items = queues[bucket_key]
                    take = min(self.max_batch, len(items))
                    cuts.append((bucket_key, deadline_driven,
                                 [item.key for item in items[:take]]))
                    queues[bucket_key] = items[take:]
                mine["cuts"] = cuts
        return mine

    def apply_note(self, every: list) -> int:
        """Dispatch one agreement's batches on this rank, as every rank
        does: `every` is each rank's note (None: that rank holds none of
        this program's items).  Rank 0's cuts in order, each keeping the
        items every rank holds, while every rank has dispatch room.
        Raises when an item's content differs between ranks.  Returns
        the items processed."""
        lead = every[0]
        if lead is None or not lead.get("cuts"):
            return 0
        held = [dict(note["held"]) if note is not None else {}
                for note in every]
        now = self.clock()
        with self._lock:
            items = {item.key: item for bucket in self._queues.values()
                     for item in bucket.items}
        for key, item in items.items():
            for rank, theirs in enumerate(held):
                if theirs.get(key, item.digest) != item.digest:
                    raise RuntimeError(
                        f"batch item {key} differs between this rank and "
                        f"rank {rank}: the ranks of a mesh must be handed "
                        f"the same items")
        rooms = [note["room"] for note in every
                 if note is not None and note["room"] is not None]
        room = min(rooms) if rooms else None
        processed = 0
        for bucket_key, deadline_driven, keys in lead["cuts"]:
            keys = [tuple(key) for key in keys]
            kept = [key for key in keys
                    if key in items and all(key in theirs
                                            for theirs in held)]
            if not kept:
                continue
            if room is not None and room <= 0:
                self.stats["gated"] += 1
                break
            with self._lock:
                queue = self._queues[bucket_key].items
                chosen = set(kept)
                batch = [items[key] for key in kept]
                self._queues[bucket_key].items = type(queue)(
                    item for item in queue if item.key not in chosen)
            if deadline_driven:
                self.stats["deadline_dispatches"] += 1
            self._dispatch(bucket_key, batch, now)
            processed += len(batch)
            if room is not None:
                room -= 1
        return processed

    def _dispatch(self, bucket_key: int, batch: list, now: float) -> None:
        """Run one popped batch and fan its results out."""
        # items are already popped: every callback MUST fire, or the
        # stream's frame silently vanishes — errors fan out as results.
        # process_batch may return None: it took ownership of the
        # items and fires their callbacks itself (the pipelined
        # results path: the device works on this batch while the
        # next one collates)
        deferred = False
        try:
            results = self.process_batch(bucket_key, batch)
            if results is None:
                deferred = True
            elif len(results) != len(batch):
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
        if not deferred:
            for item, result in zip(batch, results):
                item.callback(item.stream_id, result)

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
