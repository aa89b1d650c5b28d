# SessionTable: the session state plane.
#
# The port's own copy of aiko_services_tpu/state/sessions.py (session
# keys, shards, budgets, expiry and demotion, snapshots, the consumer
# view), on the port's share.py and state/wheel.py:
#
#   * the table is hash-sharded: each shard is its own ECProducer on
#     {table}/state/{i}, so delta fan-out, snapshot replay and consumer
#     lease churn split across shards.  Consumers subscribe shards with a
#     tenant filter.
#   * session expiry rides a private TimerWheel advanced by ONE periodic
#     engine timer; expiries surface as batch callbacks (on_expired(keys)).
#   * every tenant has a session-count and byte budget (TenantBudget).
#     Over the count budget, new sessions are shed at creation.  Over the
#     byte budget, the tenant's oldest-touched sessions are demoted to
#     dedup-only: payload dropped, key retained.
#
# Key space: (tenant, session_id) maps to the EC item "tenant.sid".
# Tenant and session ids must not contain ".", "/" or spaces.  With a KV
# memory ledger attached (attach_ledger), lease pins and demotions count
# as its lifecycle events.  state/loadgen.py drives the table open-loop.

from __future__ import annotations

import zlib
from dataclasses import dataclass

from ..observe.metrics import MirroredStats, default_registry
from ..share import EC_LEASE_TIME, ECConsumer, ECProducer
from .wheel import TimerWheel

__all__ = ["SessionTable", "SessionView", "TenantBudget",
           "session_shard", "DEMOTED"]

# EC value of a demoted session: existence without payload
DEMOTED = "(demoted)"

_BAD_KEY_CHARS = (".", "/", " ")


def session_shard(tenant: str, session_id: str, num_shards: int) -> int:
    """Stable shard index for a session key (crc32, not hash(): the
    mapping must not depend on the process's hash seed — operators
    correlate shard topics across runs)."""
    key = f"{tenant}\x00{session_id}"
    return zlib.crc32(key.encode("utf-8")) % num_shards


def _value_nbytes(value) -> int:
    """Approximate retained weight of a session payload — the budget
    currency.  Deliberately cheap and deterministic; containers
    recurse, scalars charge their storage order of magnitude."""
    if value is None:
        return 0
    if isinstance(value, (bytes, bytearray, str)):
        return len(value)
    if isinstance(value, bool):
        return 1
    if isinstance(value, (int, float)):
        return 8
    if isinstance(value, dict):
        return sum(len(str(k)) + _value_nbytes(v)
                   for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return sum(_value_nbytes(v) for v in value)
    return len(str(value))


@dataclass(frozen=True)
class TenantBudget:
    """Per-tenant admission limits.  None = unlimited."""
    max_sessions: int | None = None
    max_bytes: int | None = None


class _Session:
    __slots__ = ("tenant", "sid", "payload", "nbytes", "due", "gen",
                 "demoted", "touched")

    def __init__(self, tenant, sid, payload, nbytes, due, touched):
        self.tenant = tenant
        self.sid = sid
        self.payload = payload
        self.nbytes = nbytes
        self.due = due
        self.gen = 0            # bumped per touch: stale wheel entries
        self.demoted = False
        self.touched = touched  # last activity: the idle-demote clock

    @property
    def key(self):
        return (self.tenant, self.sid)


class _ShardEndpoint:
    """Service-shaped shim carrying one shard's EC topics — an
    ECProducer needs only runtime/topic_control/topic_out, and a full
    Service per shard would put N discovery records on the registrar
    for what is one logical table."""
    __slots__ = ("runtime", "topic_path", "topic_control", "topic_out")

    def __init__(self, runtime, base_path: str, index: int):
        self.runtime = runtime
        self.topic_path = f"{base_path}/state/{index}"
        self.topic_control = f"{self.topic_path}/control"
        self.topic_out = f"{self.topic_path}/out"


class _Shard:
    """One hash partition: its ECProducer plus delta accounting."""
    __slots__ = ("endpoint", "producer", "delta_bytes", "dirty",
                 "_counter")

    def __init__(self, runtime, base_path: str, index: int, counter):
        self.endpoint = _ShardEndpoint(runtime, base_path, index)
        self.producer = ECProducer(self.endpoint, {})
        self.delta_bytes = 0
        self.dirty = False
        self._counter = counter     # shared state_delta_bytes_total

    def publish(self, name: str, value) -> None:
        nbytes = len(name) + _value_nbytes(value)
        self.delta_bytes += nbytes
        self._counter.inc(nbytes)
        self.dirty = True
        self.producer.update(name, value)

    def retract(self, name: str) -> None:
        self.delta_bytes += len(name)
        self._counter.inc(len(name))
        self.dirty = True
        self.producer.remove(name)


class SessionTable:
    """(tenant, session_id)-keyed leased state, sharded over per-shard
    ECProducer topics, expired off a timer wheel in batches, budgeted
    per tenant.

    Single-threaded by design: call it from the owning engine's thread
    (element handlers, timers, or a loop calling step()) —
    exactly the discipline every other runtime surface already has.
    """

    def __init__(self, service, num_shards: int = 8,
                 lease_time: float = 30.0, wheel_tick: float = 0.05,
                 snapshot_interval: float = 0.0,
                 default_budget: TenantBudget | None = None,
                 budgets: dict[str, TenantBudget] | None = None,
                 on_expired=None, on_demoted=None,
                 demote_idle: float | None = None,
                 agree_lapses: bool = False):
        """`service` supplies the runtime and the topic root (a Service
        or anything with .runtime/.topic_path).  `on_expired(keys)` is
        the expiry-batch callback: one call per wheel advance that
        lapsed anything, with every lapsed (tenant, sid).
        `on_demoted(keys)` fires when the byte budget demotes sessions
        to dedup-only — both hooks release whatever the payload pinned
        OUTSIDE the table (the serving prefix cache's conversation KV
        handles ride them).
        `snapshot_interval` > 0 re-synchronizes dirty shards' live
        consumers periodically (compacted snapshot: current state, not
        the delta history); 0 leaves recovery to lease re-requests.
        `demote_idle` > 0 demotes sessions untouched for that many
        seconds BEFORE their lease lapses: the session
        survives for dedup/revival but its payload — and whatever it
        pinned outside the table, when on_demoted routes into a tiered
        KV cache — drops to the cold tier early instead of hogging the
        hot tier for a whole lease.
        `agree_lapses`: the table serves one rank of a mesh, whose ranks
        must lapse the same sessions in the same round.  Its own wheel
        then lapses and idle-demotes nothing: it proposes (take_lapses;
        lapses_pending says one waits), and apply_lapses applies the
        proposals the ranks agreed on (the serving decoder's round note
        carries rank 0's, and a pending proposal makes a note on an idle
        decoder)."""
        self.runtime = service.runtime
        self.topic_path = service.topic_path
        self.num_shards = int(num_shards)
        self.lease_time = float(lease_time)
        self.default_budget = default_budget or TenantBudget()
        self.budgets = dict(budgets or {})
        self.on_expired = on_expired
        self.on_demoted = on_demoted
        self.demote_idle = float(demote_idle) \
            if demote_idle and float(demote_idle) > 0 else None
        self._sessions: dict[tuple, _Session] = {}
        # per-tenant insertion-ordered sid → session (touch re-inserts,
        # so iteration order IS oldest-touched-first: the demote scan
        # pops from the front without sorting)
        self._by_tenant: dict[str, dict] = {}
        self._tenant_bytes: dict[str, int] = {}
        registry = default_registry()
        delta_counter = registry.counter(
            "state_delta_bytes_total",
            "approximate bytes of EC deltas published by session shards")
        self._shards = [_Shard(self.runtime, self.topic_path, i,
                               delta_counter)
                        for i in range(self.num_shards)]
        engine = self.runtime.event
        self._wheel = TimerWheel(engine.clock.now(), tick=wheel_tick)
        self._tick_timer = engine.add_timer_handler(
            self._advance, wheel_tick)
        self._snapshot_interval = float(snapshot_interval)
        self._next_snapshot = engine.clock.now() + self._snapshot_interval
        self.stats = MirroredStats(
            metric="state_session_events_total",
            help="session lifecycle events by kind",
            label="event")
        self._gauge_sessions = registry.gauge(
            "state_sessions", "live sessions in the table")
        self._gauge_bytes = registry.gauge(
            "state_session_bytes", "payload bytes pinned by live sessions")
        self._expiry_batches = registry.histogram(
            "state_expiry_batch_size", "sessions lapsed per wheel advance",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096,
                     16384, 65536))
        self._stopped = False
        self.agree_lapses = bool(agree_lapses)
        # (kind, tenant, sid) -> gen: lapses this table's clock proposes
        self._proposals: dict = {}
        # KV memory ledger: lease pins and demotions count as lifecycle
        # events (the KV bytes they pin are the prefix cache's to charge)
        self._ledger = None

    def attach_ledger(self, ledger) -> None:
        self._ledger = ledger

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._sessions)

    def get(self, tenant: str, sid: str, default=None):
        session = self._sessions.get((tenant, sid))
        return default if session is None else session.payload

    def tenant_sessions(self, tenant: str) -> int:
        return len(self._by_tenant.get(tenant, ()))

    def items(self) -> list:
        """Live sessions as [(tenant, sid, payload), ...]: everything a
        retiring runtime would hand over."""
        return [(tenant, sid, session.payload)
                for (tenant, sid), session in self._sessions.items()]

    def tenant_bytes(self, tenant: str) -> int:
        return self._tenant_bytes.get(tenant, 0)

    def shard_of(self, tenant: str, sid: str) -> int:
        return session_shard(tenant, sid, self.num_shards)

    def delta_bytes(self) -> int:
        return sum(shard.delta_bytes for shard in self._shards)

    def outstanding_timers(self) -> int:
        return len(self._wheel)

    def _budget(self, tenant: str) -> TenantBudget:
        return self.budgets.get(tenant, self.default_budget)

    # -- lifecycle API -----------------------------------------------------
    def create(self, tenant: str, sid: str, payload=None,
               lease_time: float | None = None) -> bool:
        """Admit a session.  Returns False (shed) when the tenant is at
        its session-count budget — admission refuses NEW work, it never
        evicts an established session for a newcomer."""
        if any(c in tenant for c in _BAD_KEY_CHARS) \
                or any(c in sid for c in _BAD_KEY_CHARS):
            raise ValueError(f"session key {(tenant, sid)!r} may not "
                             f"contain '.', '/' or spaces")
        key = (tenant, sid)
        existing = self._sessions.get(key)
        if existing is not None:
            self.update(tenant, sid, payload)
            self.touch(tenant, sid, lease_time)
            return True
        budget = self._budget(tenant)
        held = self._by_tenant.get(tenant)
        if budget.max_sessions is not None and held is not None \
                and len(held) >= budget.max_sessions:
            self.stats["shed"] += 1
            return False
        nbytes = _value_nbytes(payload)
        now = self.runtime.event.clock.now()
        session = _Session(tenant, sid, payload, nbytes,
                           now + (lease_time or self.lease_time), now)
        self._sessions[key] = session
        self._by_tenant.setdefault(tenant, {})[sid] = session
        self._tenant_bytes[tenant] = \
            self._tenant_bytes.get(tenant, 0) + nbytes
        self._wheel.schedule(session.due, (key, session.gen))
        self._publish(session)
        self.stats["created"] += 1
        if self._ledger is not None:
            self._ledger.event("lease_pin")
        self._gauge_sessions.inc()
        self._gauge_bytes.inc(nbytes)
        self._enforce_bytes(tenant)
        return True

    def update(self, tenant: str, sid: str, payload) -> bool:
        """Replace a session's payload (revives a demoted session)."""
        session = self._sessions.get((tenant, sid))
        if session is None:
            return False
        nbytes = _value_nbytes(payload)
        delta = nbytes - session.nbytes
        session.payload = payload
        session.nbytes = nbytes
        session.demoted = False
        # a fresh payload is activity: a just-revived session must not
        # re-demote on the next wheel tick
        session.touched = self.runtime.event.clock.now()
        self._tenant_bytes[tenant] = \
            self._tenant_bytes.get(tenant, 0) + delta
        self._gauge_bytes.inc(delta)
        self._publish(session)
        self.stats["updated"] += 1
        self._enforce_bytes(tenant)
        return True

    def touch(self, tenant: str, sid: str,
              lease_time: float | None = None) -> bool:
        """Extend the session's lease.  O(1): a fresh wheel entry is
        scheduled and the old one goes stale (gen check) — no cancel,
        no scan."""
        key = (tenant, sid)
        session = self._sessions.get(key)
        if session is None:
            return False
        now = self.runtime.event.clock.now()
        session.due = now + (lease_time or self.lease_time)
        session.touched = now
        session.gen += 1
        self._wheel.schedule(session.due, (key, session.gen))
        # re-insert → this tenant dict stays oldest-touched-first
        held = self._by_tenant[tenant]
        del held[sid]
        held[sid] = session
        self.stats["touched"] += 1
        return True

    def remove(self, tenant: str, sid: str, reason: str = "removed") -> bool:
        key = (tenant, sid)
        session = self._sessions.pop(key, None)
        if session is None:
            return False
        held = self._by_tenant.get(tenant)
        if held is not None:
            held.pop(sid, None)
            if not held:
                del self._by_tenant[tenant]
        remaining = self._tenant_bytes.get(tenant, 0) - session.nbytes
        if remaining > 0:
            self._tenant_bytes[tenant] = remaining
        else:
            self._tenant_bytes.pop(tenant, None)
        self._shards[self.shard_of(tenant, sid)].retract(
            f"{tenant}.{sid}")
        self.stats[reason] += 1
        self._gauge_sessions.dec()
        self._gauge_bytes.dec(session.nbytes)
        return True

    # -- internals ---------------------------------------------------------
    def _publish(self, session: _Session) -> None:
        value = DEMOTED if session.demoted else session.payload
        if value is None:
            value = ""
        self._shards[self.shard_of(session.tenant, session.sid)].publish(
            f"{session.tenant}.{session.sid}", value)

    def _enforce_bytes(self, tenant: str) -> None:
        """Demote the tenant's oldest-touched sessions to dedup-only
        until the tenant is back under its byte budget."""
        budget = self._budget(tenant)
        if budget.max_bytes is None:
            return
        held = self._by_tenant.get(tenant)
        if not held:
            return
        over = self._tenant_bytes.get(tenant, 0) - budget.max_bytes
        if over <= 0:
            return
        demoted = []
        for session in list(held.values()):
            if over <= 0:
                break
            if session.demoted or session.nbytes == 0:
                continue
            over -= self._demote(session)
            demoted.append(session.key)
        if demoted and self.on_demoted is not None:
            # demotion drops the payload, so whatever it pinned outside
            # the table (conversation KV handles) must release too
            self.on_demoted(demoted)

    def _demote(self, session: _Session) -> int:
        """Drop one session's payload to dedup-only; returns the bytes
        freed inside the table (the on_demoted batch frees the rest)."""
        freed = session.nbytes
        session.payload = None
        session.nbytes = 0
        session.demoted = True
        self._tenant_bytes[session.tenant] -= freed
        self._gauge_bytes.dec(freed)
        self.stats["demoted"] += 1
        if self._ledger is not None:
            self._ledger.event("lease_demote")
        self._publish(session)
        return freed

    def _lapse(self, lapsed) -> None:
        """Expire the (tenant, sid) keys of `lapsed` and deliver the
        expiry batch."""
        for tenant, sid in lapsed:
            self.remove(tenant, sid, reason="expired")
        if lapsed:
            self._expiry_batches.observe(len(lapsed))
            if self.on_expired is not None:
                self.on_expired(lapsed)

    def _idle_sessions(self, idle_before: float) -> list:
        """Sessions with a payload untouched since `idle_before`.  The
        per-tenant dicts iterate oldest-touched-first, so each scan
        stops at the first live session that is not yet idle — cost is
        O(idle found), not O(sessions)."""
        idle = []
        for held in self._by_tenant.values():
            for session in held.values():
                if session.touched > idle_before:
                    break           # oldest-first: the rest are newer
                if not session.demoted and session.nbytes:
                    idle.append(session)
        return idle

    def _demote_batch(self, sessions) -> None:
        for session in sessions:
            self._demote(session)
            self.stats["demoted_idle"] += 1
        if sessions and self.on_demoted is not None:
            self.on_demoted([session.key for session in sessions])

    def _demote_idle(self, now: float) -> None:
        """Idle-demote sweep: one pass per wheel tick over each tenant's
        oldest-touched session(s)."""
        self._demote_batch(self._idle_sessions(now - self.demote_idle))

    def take_lapses(self) -> list:
        """With agree_lapses: the lapses this table's clock proposes and
        no note has applied yet, [(kind, tenant, sid, gen)] with kind
        "expire" or "idle".  A proposal stays until a note applies it or
        a touch, lapse or demotion makes it stale, so one that rank 0
        has yet to make rides every note until it does."""
        self._prune_proposals()
        return [(kind, tenant, sid, gen)
                for (kind, tenant, sid), gen in self._proposals.items()]

    def lapses_pending(self) -> bool:
        """With agree_lapses: a proposal waits (take_lapses)."""
        self._prune_proposals()
        return bool(self._proposals)

    def _lapsable(self, kind: str, tenant: str, sid: str, gen: int):
        """The session a (kind, tenant, sid, gen) proposal would lapse,
        or None when it is stale."""
        session = self._sessions.get((tenant, sid))
        if session is None or session.gen != gen:
            return None             # touched or gone since proposed
        if kind == "idle" and (session.demoted or not session.nbytes):
            return None
        return session

    def _prune_proposals(self) -> None:
        if self._proposals:
            self._proposals = {
                key: gen for key, gen in self._proposals.items()
                if self._lapsable(*key, gen) is not None}

    def apply_lapses(self, proposals) -> None:
        """Apply agreed lapse proposals (take_lapses' shape, rank 0's on
        every rank): each session still at the proposal's lease
        generation expires or idle-demotes, and the batches are
        delivered as the table's own wheel delivers them."""
        lapsed, idle = [], []
        for kind, tenant, sid, gen in proposals:
            session = self._lapsable(kind, tenant, sid, gen)
            if session is None:
                continue
            if kind == "expire":
                lapsed.append((tenant, sid))
            else:
                idle.append(session)
        self._lapse(lapsed)
        self._demote_batch(idle)

    def _advance(self) -> None:
        """The ONE engine timer behind every session lease: advance the
        wheel, lapse what's due, deliver the expiry batch (with
        agree_lapses: propose it, and the idle demotions)."""
        if self._stopped:
            return
        now = self.runtime.event.clock.now()
        lapsed = []
        for entry in self._wheel.advance(now):
            key, gen = entry.payload
            session = self._sessions.get(key)
            if session is None or session.gen != gen:
                continue            # touched since scheduled: stale
            lapsed.append(key)
        if self.agree_lapses:
            # at most two entries a live session, pruned when stale
            # (take_lapses)
            for tenant, sid in lapsed:
                gen = self._sessions[(tenant, sid)].gen
                self._proposals[("expire", tenant, sid)] = gen  # graft: disable=lint-unbounded-cache
            if self.demote_idle is not None:
                idle_before = now - self.demote_idle
                for session in self._idle_sessions(idle_before):
                    key = ("idle", session.tenant, session.sid)
                    self._proposals[key] = session.gen  # graft: disable=lint-unbounded-cache
        else:
            self._lapse(lapsed)
            if self.demote_idle is not None:
                self._demote_idle(now)
        if self._snapshot_interval > 0 and now >= self._next_snapshot:
            self._next_snapshot = now + self._snapshot_interval
            self._compact()

    def _compact(self) -> None:
        """Periodic compacted snapshot: every dirty shard replays its
        CURRENT filtered state to its live leaseholders (the delta
        history is never replayed — compaction is implicit in the
        share dict).  Consumers apply add/update idempotently, so a
        consumer that missed deltas heals here without waiting for its
        own lease re-request."""
        for shard in self._shards:
            if not shard.dirty:
                continue
            shard.dirty = False
            producer = shard.producer
            for response_topic, consumer in list(
                    producer._consumers.items()):
                producer._synchronize(response_topic, consumer["filter"])

    def stop(self) -> None:
        """Drain: cancel the tick timer, drop every shard's control
        subscription and consumer leases.  Leak gate: after stop() the
        engine holds NO timer owned by this table."""
        if self._stopped:
            return
        self._stopped = True
        self.runtime.event.remove_timer_handler(self._tick_timer)
        for shard in self._shards:
            shard.producer.terminate()


class SessionView:
    """Consumer-side merged view of a SessionTable: one ECConsumer per
    shard (same filter), all writing one flat cache keyed
    "tenant.sid".  `tenants` narrows the subscription — a per-tenant
    dashboard receives only its tenant's deltas from every shard."""

    def __init__(self, runtime, table_topic_path: str, num_shards: int,
                 tenants="*", lease_time: float = EC_LEASE_TIME):
        self.cache: dict = {}
        self._consumers = [
            ECConsumer(runtime, self.cache,
                       f"{table_topic_path}/state/{i}/control",
                       item_filter=tenants, lease_time=lease_time)
            for i in range(int(num_shards))]

    @property
    def synchronized(self) -> bool:
        return all(c.synchronized for c in self._consumers)

    def __len__(self) -> int:
        return len(self.cache)

    def get(self, tenant: str, sid: str, default=None):
        return self.cache.get(f"{tenant}.{sid}", default)

    def add_handler(self, handler) -> None:
        for consumer in self._consumers:
            consumer.add_handler(handler)

    def share_request_stats(self) -> dict:
        totals = {"share_requests": 0, "share_requests_deduped": 0}
        for consumer in self._consumers:
            for key in totals:
                totals[key] += consumer.stats[key]
        return totals

    def terminate(self) -> None:
        for consumer in self._consumers:
            consumer.terminate()
