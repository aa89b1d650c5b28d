# Chaos transport: seeded, scriptable fault injection for the data plane.
#
# The port's own copy of aiko_services_tpu/transport/chaos.py:
#
#   * FaultRule / FaultPlan — a schedule of per-topic / per-client faults
#     (drop, delay, duplicate, reorder, payload truncation) plus network
#     partitions, deterministic under a seed: a single random.Random
#     consumed in delivery order, so the same plan + the same engine
#     stepping reproduces the same fault sequence bit-for-bit;
#   * ChaosBroker — a MemoryBroker whose per-recipient delivery seam
#     (`_deliver`) consults the plan;
#   * ChaosMessage — the same plan applied at the client edge of ANY
#     Message transport (publish-side), for brokers this process does not
#     own.
#
# Fault semantics per delivery (one message, one recipient):
#   drop       message never reaches this recipient;
#   delay      message enqueued after `delay` seconds of engine time;
#   duplicate  recipient sees the message `copies + 1` times;
#   reorder    message held for one engine turn, so later messages in the
#              same burst overtake it (deterministic local reordering);
#   truncate   bytes payloads cut to `truncate_to` bytes — exercises the
#              wire-envelope decode error paths;
#   partition  clients are assigned to named groups; while a partition
#              window is active, messages do not cross group boundaries.
#
# Rules match MQTT-style topic patterns, fnmatch client ids (recipient
# AND sender), an optional payload substring (e.g. target only the
# "(primary absent)" LWT), count windows (`after`, `count`) and clock
# windows (`start`, `stop` in engine time).  Everything is observable:
# per-rule fired counts and a plan-wide stats Counter, so a soak can
# report exactly what it injected.

from __future__ import annotations

import random
from dataclasses import dataclass, field
from fnmatch import fnmatchcase

from ..observe import flight as _flight
from ..observe.metrics import MirroredStats
from .memory import MemoryBroker
from .message import Message, topic_matches

__all__ = ["FaultRule", "FaultPlan", "ChaosBroker", "ChaosMessage",
           "FAULT_KINDS"]

FAULT_KINDS = ("drop", "delay", "duplicate", "reorder", "truncate")


@dataclass
class FaultRule:
    """One scheduled fault.  See the module docstring for semantics."""
    kind: str
    topic: str = "#"                # MQTT pattern the topic must match
    client: str = "*"               # fnmatch on the RECIPIENT client id
    sender: str = "*"               # fnmatch on the SENDER client id
    probability: float = 1.0        # per matching delivery (seeded rng)
    delay: float = 0.05             # seconds, kind="delay"
    copies: int = 1                 # extra deliveries, kind="duplicate"
    truncate_to: int = 8            # bytes kept, kind="truncate"
    payload_match: str | None = None  # substring the payload must contain
    after: int = 0                  # skip the first N matching deliveries
    count: int | None = None        # fire at most N times
    start: float | None = None      # active window in engine-clock time
    stop: float | None = None
    seen: int = field(default=0, compare=False)    # matching deliveries
    fired: int = field(default=0, compare=False)   # faults applied

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")

    def _payload_contains(self, payload) -> bool:
        if self.payload_match is None:
            return True
        needle = self.payload_match
        if isinstance(payload, (bytes, bytearray, memoryview)):
            return needle.encode("utf-8") in bytes(payload)
        return needle in str(payload)

    def matches(self, topic, sender_id, recipient_id, payload, now) -> bool:
        if self.start is not None and now < self.start:
            return False
        if self.stop is not None and now >= self.stop:
            return False
        if not topic_matches(self.topic, topic):
            return False
        if not fnmatchcase(recipient_id or "", self.client):
            return False
        if not fnmatchcase(sender_id or "", self.sender):
            return False
        return self._payload_contains(payload)


@dataclass
class _Partition:
    groups: list                    # list of lists of client-id patterns
    start: float | None = None
    stop: float | None = None

    def active(self, now: float) -> bool:
        return (self.start is None or now >= self.start) and \
            (self.stop is None or now < self.stop)

    def group_of(self, client_id: str) -> int | None:
        for index, patterns in enumerate(self.groups):
            if any(fnmatchcase(client_id or "", p) for p in patterns):
                return index
        return None

    def severs(self, sender_id: str, recipient_id: str) -> bool:
        sender_group = self.group_of(sender_id)
        recipient_group = self.group_of(recipient_id)
        # unassigned clients (the registrar, observers) see everyone
        if sender_group is None or recipient_group is None:
            return False
        return sender_group != recipient_group


class _Verdict:
    """The composed decision for one (message, recipient) delivery."""
    __slots__ = ("drop", "delay", "copies", "truncate_to", "reorder")

    def __init__(self):
        self.drop = False
        self.delay = 0.0
        self.copies = 0
        self.truncate_to: int | None = None
        self.reorder = False


class FaultPlan:
    """A seeded schedule of faults.  Thread-compatible with the memory
    broker (decisions happen on the delivery path, outside the broker
    lock, which the engine serializes in deterministic tests)."""

    def __init__(self, seed: int = 0, rules=()):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[FaultRule] = list(rules)
        self.partitions: list[_Partition] = []
        # Counter-compatible (missing keys read 0); injected-fault
        # counts also mirror onto the metrics registry, so a soak's
        # telemetry snapshot shows chaos_faults_total beside the
        # recovery counters it provoked; each fault also lands in the
        # flight recorder's rings (observe/flight.py record_fault)
        self.stats = MirroredStats(
            metric="chaos_faults_total",
            help="chaos faults injected by kind")

    # -- authoring ---------------------------------------------------------
    def add(self, rule: FaultRule) -> FaultRule:
        self.rules.append(rule)
        return rule

    def drop(self, **kwargs) -> FaultRule:
        return self.add(FaultRule("drop", **kwargs))

    def delay(self, **kwargs) -> FaultRule:
        return self.add(FaultRule("delay", **kwargs))

    def duplicate(self, **kwargs) -> FaultRule:
        return self.add(FaultRule("duplicate", **kwargs))

    def reorder(self, **kwargs) -> FaultRule:
        return self.add(FaultRule("reorder", **kwargs))

    def truncate(self, **kwargs) -> FaultRule:
        return self.add(FaultRule("truncate", **kwargs))

    def partition(self, groups, start: float | None = None,
                  stop: float | None = None) -> "_Partition":
        """Sever the network between client groups for [start, stop) in
        engine-clock time.  `groups` is a list of lists of client-id
        fnmatch patterns; clients matching no group are unaffected."""
        partition = _Partition([list(g) for g in groups], start, stop)
        self.partitions.append(partition)
        return partition

    def clear(self) -> None:
        self.rules.clear()
        self.partitions.clear()

    # -- decision ----------------------------------------------------------
    def decide(self, topic, sender_id, recipient_id, payload,
               now: float) -> _Verdict:
        verdict = _Verdict()
        for partition in self.partitions:
            if partition.active(now) and \
                    partition.severs(sender_id, recipient_id):
                verdict.drop = True
                self.stats["partitioned"] += 1
                _flight.record_fault("partitioned", topic, sender_id,
                                     recipient_id, now)
                return verdict
        for rule in self.rules:
            if not rule.matches(topic, sender_id, recipient_id, payload,
                                now):
                continue
            rule.seen += 1
            if rule.seen <= rule.after:
                continue
            if rule.count is not None and rule.fired >= rule.count:
                continue
            # one rng draw per probabilistic rule evaluation, in rule
            # order: the fault sequence is a pure function of (seed,
            # delivery order)
            if rule.probability < 1.0 and \
                    self.rng.random() >= rule.probability:
                continue
            rule.fired += 1
            self.stats[rule.kind] += 1
            _flight.record_fault(rule.kind, topic, sender_id,
                                 recipient_id, now)
            if rule.kind == "drop":
                verdict.drop = True
                return verdict
            if rule.kind == "delay":
                verdict.delay = max(verdict.delay, rule.delay)
            elif rule.kind == "duplicate":
                verdict.copies += rule.copies
            elif rule.kind == "reorder":
                verdict.reorder = True
            elif rule.kind == "truncate":
                verdict.truncate_to = rule.truncate_to
        return verdict

    def injected(self) -> int:
        """Total faults applied so far (all kinds + partition drops)."""
        return sum(self.stats.values())


def _apply_truncate(payload, nbytes: int):
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return bytes(payload)[:nbytes]
    return str(payload)[:nbytes]


class ChaosBroker(MemoryBroker):
    """A MemoryBroker that routes every delivery through a FaultPlan.

    `engine` provides the clock for rule windows and the timer wheel for
    delayed/reordered deliveries; without one, delay and reorder degrade
    to immediate delivery (drop/duplicate/truncate/partition still
    apply, with now=0.0 for window checks)."""

    def __init__(self, plan: FaultPlan | None = None, engine=None,
                 data_queue_limit: int = 1024):
        super().__init__(data_queue_limit)
        self.plan = plan or FaultPlan()
        self.engine = engine

    def _now(self) -> float:
        return self.engine.clock.now() if self.engine is not None else 0.0

    def _deliver(self, clients, topic, payload, is_data, sender) -> None:
        sender_id = getattr(sender, "client_id", "") or ""
        now = self._now()
        for client in clients:
            recipient_id = getattr(client, "client_id", "") or ""
            verdict = self.plan.decide(topic, sender_id, recipient_id,
                                       payload, now)
            if verdict.drop:
                continue
            delivered = payload if verdict.truncate_to is None else \
                _apply_truncate(payload, verdict.truncate_to)

            def enqueue(client=client, delivered=delivered):
                client._enqueue(topic, delivered, is_data,
                                self.data_queue_limit, self.stats)

            for _ in range(1 + verdict.copies):
                if verdict.delay > 0.0 and self.engine is not None:
                    self.engine.add_oneshot_handler(enqueue, verdict.delay)
                elif verdict.reorder and self.engine is not None:
                    # one-turn hold: later messages in this burst overtake
                    self.engine.add_oneshot_handler(enqueue, 0.0)
                else:
                    enqueue()


class ChaosMessage(Message):
    """Client-edge chaos for transports whose broker this process does
    not own: wraps any Message and applies the plan on the PUBLISH side
    (sender faults only — the wrapped transport's broker fans out, so
    per-recipient rules cannot apply here; use ChaosBroker for those)."""

    def __init__(self, inner: Message, plan: FaultPlan, engine=None,
                 client_id: str | None = None):
        super().__init__(inner.on_message, inner.subscriptions)
        self.inner = inner
        self.plan = plan
        self.engine = engine
        self.client_id = client_id or \
            getattr(inner, "client_id", "") or "chaos"
        self.BINARY = getattr(inner, "BINARY", False)

    def _now(self) -> float:
        return self.engine.clock.now() if self.engine is not None else 0.0

    def publish(self, topic, payload, retain=False, wait=False) -> None:
        verdict = self.plan.decide(topic, self.client_id, "*", payload,
                                   self._now())
        if verdict.drop:
            return
        delivered = payload if verdict.truncate_to is None else \
            _apply_truncate(payload, verdict.truncate_to)

        def send():
            self.inner.publish(topic, delivered, retain=retain, wait=wait)

        for _ in range(1 + verdict.copies):
            if (verdict.delay > 0.0 or verdict.reorder) and \
                    self.engine is not None:
                self.engine.add_oneshot_handler(send, verdict.delay)
            else:
                send()

    # -- passthrough -------------------------------------------------------
    def connect(self) -> None:
        self.inner.connect()

    def crash(self) -> None:
        """Abrupt-death passthrough (the soak kills a runtime through
        its transport, chaos wrapper or not)."""
        crash = getattr(self.inner, "crash", None)
        if crash is not None:
            crash()
        else:
            self.inner.disconnect()

    def disconnect(self, *args, **kwargs) -> None:
        self.inner.disconnect(*args, **kwargs)

    def connected(self) -> bool:
        return self.inner.connected()

    def subscribe(self, topic) -> None:
        self.subscriptions.add(topic)
        self.inner.subscribe(topic)

    def unsubscribe(self, topic) -> None:
        self.subscriptions.discard(topic)
        self.inner.unsubscribe(topic)

    def set_last_will_and_testament(self, topic, payload,
                                    retain=False) -> None:
        self.inner.set_last_will_and_testament(topic, payload, retain)
