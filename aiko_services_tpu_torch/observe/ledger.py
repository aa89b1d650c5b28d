# KV memory ledger: cross-tier byte attribution, always-on leak auditing
# and capacity pressure signals.
#
# The port's own copy of aiko_services_tpu/observe/ledger.py.  Every
# block-lifecycle seam reports through it:
#
#   * BlockPool alloc / release call device_delta with the owning tenant,
#     so ledger device totals conserve against used_blocks() *
#     block_nbytes by construction: retains and refcount handoffs
#     (prefix aliasing, harvest) move ownership, not bytes, and stay
#     invisible here;
#   * HostBlockStore put / evict / pop_promoted call host_delta exactly
#     where its own per-tenant bytes move, plus move() counters for the
#     demotion and promotion flows;
#   * the dense (unpaged) PrefixKVCache charges insert / evict bytes
#     directly: device-tier truth is then cache.bytes_used;
#   * violations (double release, conservation drift, host orphans) count
#     kv_ledger_violations_total, latch the kv_ledger_violations gauge and
#     record a flight-recorder fault carrying the offending chain key.
#
# audit() runs on an engine timer (attach_engine), so the leak checks run
# continuously; engine callbacks are serialized, so transient intra-call
# imbalances are never observed.  Family names and labels are the JAX
# package's:
#
#   kv_ledger_bytes{tier, tenant}         live attribution
#   kv_ledger_pinned_bytes{tenant}        device bytes with live refs
#   kv_ledger_byte_seconds{tenant}        integrated footprint cost
#   kv_ledger_events_total{kind}          lifecycle event counts
#   kv_ledger_moves_total{tenant, dir}    demote / promote flows
#   kv_ledger_violations                  latched violation level
#   kv_ledger_violations_total{kind}      violations by kind
#   kv_ledger_host_pressure               host bytes_used / max_bytes

from __future__ import annotations

import collections
import time

from .metrics import MirroredStats, default_registry
from ..utils import get_logger

__all__ = ["KVMemoryLedger", "assert_ledger_clean", "seed_ledger_leak"]

_EVENT_KINDS = (
    "alloc", "release", "cow", "cache_insert", "cache_evict",
    "demote", "host_evict", "promote", "install", "migrate_out",
    "migrate_in", "session_pin", "session_demote", "lease_pin",
    "lease_demote",
)


def _tenant_key(tenant) -> str:
    return str(tenant or "default")


class KVMemoryLedger:
    """Per-tenant, per-tier KV byte accounting + invariant auditor.

    Event-loop single-threaded like everything it attaches to; every
    seam guards `if ledger is not None`, so an un-ledgered serving
    stack pays nothing."""

    def __init__(self, name: str = "kv", registry=None, clock=None,
                 trend_window: float = 30.0,
                 max_violations: int = 64):
        self.name = str(name)
        self.logger = get_logger(f"observe.ledger.{name}")
        self._registry = registry or default_registry()
        self._clock = clock or time.monotonic
        self.trend_window = float(trend_window)
        # per-tenant balances (bytes); zero balances are dropped,
        # negative ones kept visible for the auditor
        self._device: dict = {}
        self._host: dict = {}
        self._byte_seconds: dict = {}
        self._accrued_at: dict = {}
        # attached components (audit truth sources)
        self._pool = None
        self._store = None
        self._cache = None
        self._engine = None
        self._timer = None
        # occupancy trend ring: (t, device total bytes)
        self._occupancy = collections.deque(maxlen=256)
        self.violations: collections.deque = collections.deque(
            maxlen=max(1, int(max_violations)))
        self._violation_total = 0
        self._open: set = set()     # audit findings currently standing
        self.stats = MirroredStats(
            {kind: 0 for kind in _EVENT_KINDS},
            metric="kv_ledger_events_total",
            help="KV ledger lifecycle events by kind",
            registry=self._registry,
            labels={"ledger": self.name})
        self._gauge_violations = self._registry.gauge(
            "kv_ledger_violations",
            "latched count of ledger invariant violations",
            labels={"ledger": self.name})
        self._gauge_pressure = self._registry.gauge(
            "kv_ledger_host_pressure",
            "host tier bytes_used / max_bytes",
            labels={"ledger": self.name})
        self._tier_gauges: dict = {}
        self._pinned_gauges: dict = {}
        self._bs_gauges: dict = {}
        self._move_counters: dict = {}
        self._violation_counters: dict = {}

    # -- attachment --------------------------------------------------------
    def attach_pool(self, pool) -> None:
        """Adopt a BlockPool as the device-tier truth source (the pool
        reports through device_delta once its attach_ledger is set —
        callers use pool.attach_ledger(ledger), which calls back)."""
        self._pool = pool

    def attach_host(self, store) -> None:
        self._store = store

    def attach_cache(self, cache) -> None:
        self._cache = cache

    def attach_engine(self, engine, interval: float = 1.0) -> None:
        """Run audit() on an engine timer — the always-on promotion of
        the test-time leak checks."""
        self.detach_engine()
        self._engine = engine
        self._timer = engine.add_timer_handler(self.audit,
                                               float(interval))

    def detach_engine(self) -> None:
        if self._engine is not None and self._timer is not None:
            self._engine.remove_timer_handler(self._timer)
        self._engine = None
        self._timer = None

    # -- event API ---------------------------------------------------------
    def device_delta(self, tenant, nbytes: int, kind: str = "") -> None:
        """One physical device-tier transition: positive on alloc /
        dense insert, negative on the refs 1->0 release / dense evict.
        Refcount handoffs never call this."""
        self._delta(self._device, "device", tenant, nbytes, kind)
        self._note_occupancy()

    def host_delta(self, tenant, nbytes: int, kind: str = "") -> None:
        self._delta(self._host, "host", tenant, nbytes, kind)

    def _delta(self, balances: dict, tier: str, tenant,
               nbytes: int, kind: str) -> None:
        tenant = _tenant_key(tenant)
        self._accrue(tenant)
        total = balances.get(tenant, 0) + int(nbytes)
        if total:
            balances[tenant] = total
        else:
            balances.pop(tenant, None)
        if total < 0:
            self.violation(
                "negative-balance", tenant=tenant,
                detail=f"{tier} balance {total} after {kind or 'delta'}"
                       f" of {int(nbytes)}")
        self._tier_gauge(tier, tenant).set(total)
        if kind:
            self.stats[kind] += 1

    def event(self, kind: str, count: int = 1) -> None:
        """Count a lifecycle event with no byte movement (session
        pins, migration shipments)."""
        self.stats[kind] += int(count)

    def move(self, tenant, direction: str, count: int = 1) -> None:
        """Count a cross-tier move (direction: demote | promote) for
        the per-tenant flow columns in the SLO report."""
        tenant = _tenant_key(tenant)
        counter = self._move_counters.get((tenant, direction))
        if counter is None:
            counter = self._registry.counter(
                "kv_ledger_moves_total",
                "cross-tier KV block moves by tenant and direction",
                labels={"ledger": self.name, "tenant": tenant,
                        "dir": direction})
            self._move_counters[(tenant, direction)] = counter
        counter.inc(int(count))

    def violation(self, kind: str, tenant: str = "",
                  chain_key: str = "", detail: str = "") -> dict:
        """Record one invariant violation: bounded deque + counters +
        latched level gauge + a flight-recorder fault that carries the
        offending chain key into the DumpOnAlert postmortem (the
        level-rule alert record itself has no sketch exemplars — the
        fault ring is how the key reaches the dump)."""
        self._violation_total += 1
        record = {"kind": kind, "tenant": tenant,
                  "chain_key": chain_key, "detail": detail,
                  "t": self._clock()}
        self.violations.append(record)
        counter = self._violation_counters.get(kind)
        if counter is None:
            counter = self._registry.counter(
                "kv_ledger_violations_total",
                "ledger invariant violations by kind",
                labels={"ledger": self.name, "kind": kind})
            self._violation_counters[kind] = counter
        counter.inc()
        self._gauge_violations.set(self._violation_total)
        from . import flight
        flight.record_fault(f"ledger-{kind}",
                            topic=chain_key or tenant)
        self.logger.warning(
            "ledger %s: %s violation tenant=%r chain=%r %s",
            self.name, kind, tenant, chain_key, detail)
        return record

    # -- queries -----------------------------------------------------------
    def device_bytes(self, tenant=None) -> int:
        if tenant is None:
            return sum(self._device.values())
        return self._device.get(_tenant_key(tenant), 0)

    def host_bytes(self, tenant=None) -> int:
        if tenant is None:
            return sum(self._host.values())
        return self._host.get(_tenant_key(tenant), 0)

    def byte_seconds(self, tenant=None) -> float:
        if tenant is None:
            return float(sum(self._byte_seconds.values()))
        return float(self._byte_seconds.get(_tenant_key(tenant), 0.0))

    def tenants(self) -> list:
        return sorted(set(self._device) | set(self._host))

    def host_pressure(self) -> float:
        store = self._store
        if store is None or not getattr(store, "max_bytes", None):
            return 0.0
        return store.bytes_used / store.max_bytes

    def device_trend(self, window: float | None = None) -> float | None:
        """Device-footprint slope in bytes/second over the trend
        window — the relief-rate input to byte-aware admission (a
        negative trend means blocks are draining)."""
        window = self.trend_window if window is None else float(window)
        now = self._clock()
        samples = [(t, b) for t, b in self._occupancy
                   if now - t <= window]
        if len(samples) < 2:
            return None
        (t0, b0), (t1, b1) = samples[0], samples[-1]
        if t1 <= t0:
            return None
        return (b1 - b0) / (t1 - t0)

    def pinned_bytes(self, tenant) -> int:
        """Device bytes the tenant cannot currently evict: total minus
        the prefix cache's refs==0 (evictable) bytes.  Slot-resident
        blocks are pinned by definition — they are not in the cache."""
        tenant = _tenant_key(tenant)
        total = self._device.get(tenant, 0)
        cache = self._cache
        if cache is None or total <= 0:
            return max(0, total)
        evictable = cache.evictable_bytes(tenant)
        return max(0, total - evictable)

    # -- accrual / trend ---------------------------------------------------
    def _accrue(self, tenant: str) -> None:
        now = self._clock()
        last = self._accrued_at.get(tenant)
        if last is not None and now > last:
            resident = self._device.get(tenant, 0) + \
                self._host.get(tenant, 0)
            if resident > 0:
                total = self._byte_seconds.get(tenant, 0.0) + \
                    resident * (now - last)
                self._byte_seconds[tenant] = total
                self._bs_gauge(tenant).set(total)
        self._accrued_at[tenant] = now

    def _note_occupancy(self) -> None:
        self._occupancy.append(
            (self._clock(), sum(self._device.values())))

    # -- gauge caches ------------------------------------------------------
    def _tier_gauge(self, tier: str, tenant: str):
        gauge = self._tier_gauges.get((tier, tenant))
        if gauge is None:
            gauge = self._registry.gauge(
                "kv_ledger_bytes",
                "KV bytes attributed by tier and tenant",
                labels={"ledger": self.name, "tier": tier,
                        "tenant": tenant})
            self._tier_gauges[(tier, tenant)] = gauge
        return gauge

    def _pinned_gauge(self, tenant: str):
        gauge = self._pinned_gauges.get(tenant)
        if gauge is None:
            gauge = self._registry.gauge(
                "kv_ledger_pinned_bytes",
                "device KV bytes with live references by tenant",
                labels={"ledger": self.name, "tenant": tenant})
            self._pinned_gauges[tenant] = gauge
        return gauge

    def _bs_gauge(self, tenant: str):
        gauge = self._bs_gauges.get(tenant)
        if gauge is None:
            gauge = self._registry.gauge(
                "kv_ledger_byte_seconds",
                "integrated KV byte-seconds by tenant",
                labels={"ledger": self.name, "tenant": tenant})
            self._bs_gauges[tenant] = gauge
        return gauge

    # -- the auditor -------------------------------------------------------
    def audit(self) -> list:
        """One invariant sweep (engine-timer driven in production):
        conservation against the component truth sources, the pool's
        gauge twin, host-tier internal accounting, and negative
        balances.  Standing findings are deduplicated — a persistent
        drift fires ONE violation when it appears, not one per tick.
        Returns the new violation records."""
        for tenant in list(set(self._device) | set(self._host)):
            self._accrue(tenant)
        self._note_occupancy()
        found: dict = {}
        pool, store, cache = self._pool, self._store, self._cache
        if pool is not None:
            used = pool.used_blocks()
            if used != pool._used:
                found[("gauge-drift", "", "")] = (
                    f"pool {pool.name}: incremental used {pool._used} "
                    f"!= refs scan {used}")
            expected = used * pool.block_nbytes
            if self.device_bytes() != expected:
                found[("device-conservation", "", "")] = (
                    f"ledger device {self.device_bytes()} != pool "
                    f"{expected} ({used} blocks)")
        elif cache is not None and getattr(cache, "pool", None) is None:
            if self.device_bytes() != cache.bytes_used:
                found[("device-conservation", "", "")] = (
                    f"ledger device {self.device_bytes()} != cache "
                    f"bytes_used {cache.bytes_used}")
        if store is not None:
            if self.host_bytes() != store.bytes_used:
                found[("host-conservation", "", "")] = (
                    f"ledger host {self.host_bytes()} != store "
                    f"bytes_used {store.bytes_used}")
            recomputed: dict = {}
            newest: dict = {}
            for node in store._nodes.values():
                recomputed[node.tenant] = \
                    recomputed.get(node.tenant, 0) + node.nbytes
                newest[node.tenant] = node.key
            for tenant in set(recomputed) | set(store._tenant_bytes):
                if recomputed.get(tenant, 0) != \
                        store._tenant_bytes.get(tenant, 0):
                    # the newest entry for the tenant is the orphan in
                    # every seeded/realistic case (accounting is
                    # updated with insertion, so drift names the
                    # latest arrival)
                    found[("host-orphan", tenant,
                           newest.get(tenant, ""))] = (
                        f"store {store.name}: tenant {tenant} nodes "
                        f"sum {recomputed.get(tenant, 0)} != recorded "
                        f"{store._tenant_bytes.get(tenant, 0)}")
                ledger_side = self._host.get(tenant, 0)
                if store._tenant_bytes.get(tenant, 0) != ledger_side:
                    found[("host-conservation", tenant, "")] = (
                        f"ledger host[{tenant}] {ledger_side} != "
                        f"store {store._tenant_bytes.get(tenant, 0)}")
        for balances in (self._device, self._host):
            for tenant, total in balances.items():
                if total < 0:
                    found[("negative-balance", tenant, "")] = (
                        f"balance {total}")
        new = []
        for (kind, tenant, chain_key), detail in found.items():
            if (kind, tenant, chain_key) in self._open:
                continue
            new.append(self.violation(kind, tenant=tenant,
                                      chain_key=chain_key,
                                      detail=detail))
        self._open = set(found)
        # level publishes every tick (pressure + pinned split are
        # lazy: computed here, not event-driven)
        self._gauge_pressure.set(self.host_pressure())
        if cache is not None:
            for tenant in list(self._device):
                self._pinned_gauge(tenant).set(
                    self.pinned_bytes(tenant))
        return new


def _check(condition, message: str) -> None:
    # explicit raise, not `assert`: the audit must keep holding under
    # python -O (AssertionError so pytest renders it like a test
    # assertion)
    if not condition:
        raise AssertionError(message)


def assert_ledger_clean(pool=None, store=None, cache=None,
                        ledger=None, empty: bool = True) -> None:
    """The shared leak audit: the assertions the
    paged / tiered / drain-migrate tests used to carry inline, behind
    one seam.  With empty=True (the post-drain default) every tier
    must be at zero; empty=False checks only the internal-consistency
    invariants (gauge twins, cross-structure conservation)."""
    if cache is not None:
        pool = pool if pool is not None \
            else getattr(cache, "pool", None)
        store = store if store is not None \
            else getattr(cache, "host_store", None)
    if pool is not None:
        used = pool.used_blocks()
        _check(pool._used == used,
               f"pool {pool.name}: gauge twin {pool._used} != {used}")
        free_ids = set(pool._free)
        _check(len(free_ids) == len(pool._free),
               f"pool {pool.name}: duplicate ids on the free list")
        if empty:
            _check(used == 0,
                   f"pool {pool.name}: {used} blocks still owned")
            _check(len(pool._free) == pool.num_blocks - 1,
                   f"pool {pool.name}: free list {len(pool._free)} "
                   f"!= {pool.num_blocks - 1}")
    if cache is not None:
        recomputed = sum(node.nbytes
                         for node in cache._nodes.values())
        _check(cache.bytes_used == recomputed,
               f"cache bytes_used {cache.bytes_used} != nodes "
               f"{recomputed}")
        if empty:
            _check(cache.bytes_used == 0,
                   f"cache holds {cache.bytes_used} bytes")
            _check(not cache._nodes,
                   f"cache holds {len(cache._nodes)} nodes")
    if store is not None:
        recomputed = sum(node.nbytes
                         for node in store._nodes.values())
        _check(store.bytes_used == recomputed,
               f"store {store.name}: bytes_used {store.bytes_used} "
               f"!= nodes {recomputed}")
        _check(store.bytes_used == sum(store._tenant_bytes.values()),
               f"store {store.name}: tenant split disagrees with "
               f"total")
        if empty:
            _check(store.bytes_used == 0 and not store._nodes,
                   f"store {store.name}: {len(store._nodes)} host "
                   f"blocks still resident")
    if ledger is not None:
        ledger.audit()
        _check(not ledger._open,
               f"ledger {ledger.name}: audit found "
               f"{sorted(ledger._open)}")
        if empty:
            _check(ledger.device_bytes() == 0,
                   f"ledger device tier {ledger.device_bytes()}")
            _check(ledger.host_bytes() == 0,
                   f"ledger host tier {ledger.host_bytes()}")


def seed_ledger_leak(cache=None, store=None,
                     kind: str = "double-release",
                     key: str | None = None) -> str:
    """Chaos hook: deliberately break one ledger invariant so the
    always-on auditor's detection -> alert -> postmortem path can be
    exercised end to end.  Returns the chain key the violation will
    carry (the thing the flight dump must name).

    kinds:
      double-release — release a prefix-cache chain key whose refs are
        already zero (the classic paired-release bug);
      orphan-host — register a host block bypassing the store's byte
        accounting (the classic forgotten-accounting bug)."""
    if kind == "double-release":
        if cache is None:
            raise ValueError("double-release needs the prefix cache")
        if key is None:
            for node_key, node in cache._nodes.items():
                if node.refs == 0:
                    key = node_key
                    break
        if key is None:
            raise ValueError("no refs==0 cached chain to re-release")
        cache.release([key])
        return key

    if kind == "orphan-host":
        if store is None:
            raise ValueError("orphan-host needs the host store")
        donor = next(reversed(store._nodes.values()), None) \
            if store._nodes else None

        class _Orphan:
            pass

        orphan = _Orphan()
        orphan.key = key or "orphan-chain"
        orphan.parent = donor.key if donor is not None else ""
        orphan.tenant = donor.tenant if donor is not None \
            else "default"
        orphan.k_rows = donor.k_rows if donor is not None else []
        orphan.v_rows = donor.v_rows if donor is not None else []
        orphan.nbytes = donor.nbytes if donor is not None else 4096
        store._nodes[orphan.key] = orphan      # bytes NOT accounted
        return orphan.key

    raise ValueError(f"unknown leak kind {kind!r}")
