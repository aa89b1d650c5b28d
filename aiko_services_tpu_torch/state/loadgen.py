# Open-loop session load generator.
#
# The port's own copy of aiko_services_tpu/state/loadgen.py.  It drives a
# SessionTable through a real runtime (engine, broker, EC shard topics, a
# consumer-side SessionView) with seeded Poisson arrivals and a tenant
# mix, while the observe layer records what happened: sessions/s, lease
# churn, shard delta bytes, and the event engine's own handler-latency
# histogram.
#
# Open-loop means arrivals do not wait for the system: the generator
# schedules create / touch / update / expire lifecycles off virtual time
# at the configured rate (a closed-loop generator hides knees by slowing
# down with the system).  Every per-op path is O(1) (wheel schedule and
# cancel, flat-view EC update, hash-shard lookup), so the handler p95
# must stay flat as cardinality steps between rungs; after the drain,
# no session and no timer is left anywhere (table wheel and engine).
#
# Everything runs on a VirtualClock: a large steady state over minutes
# of virtual time replays deterministically in seconds of wall time,
# while handler latency is still measured in wall time
# (time.perf_counter in the engine's handler guard).  Counts in virtual
# time are deterministic for a seed; wall-time latencies are not.

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from ..event import EventEngine, VirtualClock
from ..observe.export import series_quantile
from ..observe.metrics import default_registry
from ..process import ProcessRuntime
from ..service import Service
from ..transport.memory import MemoryBroker, MemoryMessage
from .sessions import SessionTable, SessionView, TenantBudget

__all__ = ["TenantSpec", "LoadConfig", "run_session_load"]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant in the arrival mix.  `flood=True` marks the tenant
    whose budget is sized to be breached — the budget-enforcement
    probe."""
    name: str
    weight: float = 1.0
    flood: bool = False


# polite/bulk carry the traffic; flood is over-weighted relative to the
# budget it will be given, so shed/demote verdicts MUST appear there
DEFAULT_TENANTS = (
    TenantSpec("polite", weight=3.0),
    TenantSpec("bulk", weight=5.0),
    TenantSpec("flood", weight=2.0, flood=True),
)


@dataclass
class LoadConfig:
    seed: int = 11
    rungs: tuple = (1_000, 10_000, 100_000)
    lease_time: float = 20.0        # virtual seconds
    touches: int = 2                # lease extensions per session life
    num_shards: int = 8
    tick: float = 0.05              # drive loop tick (virtual seconds)
    payload_bytes: int = 64
    tenants: tuple = DEFAULT_TENANTS
    view_tenant: str = "polite"     # the consumer-side subscription
    snapshot_interval: float = 0.0  # per-shard compaction cadence
    # flatness policy: p95 may move at most two log2 histogram buckets
    # between the smallest and largest rung
    max_p95_ratio: float = 4.0


class _HandlerLatencyProbe:
    """Delta view over the process-wide event_handler_seconds
    histogram: rung-local p95/mean regardless of what ran before."""

    def __init__(self):
        registry = default_registry()
        self._hist = registry.histogram(
            "event_handler_seconds",
            "wall time per event-engine handler invocation")
        self._counts = list(self._hist.counts)
        self._sum = self._hist.sum
        self._count = self._hist.count

    def delta(self) -> dict:
        counts = [a - b for a, b in zip(self._hist.counts, self._counts)]
        count = self._hist.count - self._count
        total = self._hist.sum - self._sum
        p95 = series_quantile({"count": count, "counts": counts,
                               "bounds": list(self._hist.bounds)}, 0.95)
        return {
            "count": count,
            "p95_ms": round(p95 * 1000.0, 4),
            "mean_us": round(total / count * 1e6, 2) if count else 0.0,
        }


@dataclass
class _Lifecycle:
    """Bookkeeping for one rung's in-flight session lifecycles."""
    counter: int = 0
    touches_scheduled: int = 0
    peak_sessions: int = 0
    create_failures: dict = field(default_factory=dict)


def _run_rung(config: LoadConfig, target: int, rng: random.Random) -> dict:
    """One cardinality rung on a FRESH engine/broker/runtimes: ramp to
    ~`target` concurrent sessions, hold, then drain to zero."""
    engine = EventEngine(VirtualClock())
    broker = MemoryBroker()

    def make_runtime(name):
        def transport_factory(on_message, lwt_topic, lwt_payload,
                              lwt_retain):
            return MemoryMessage(
                on_message=on_message, broker=broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain)
        return ProcessRuntime(name=name, engine=engine,
                              transport_factory=transport_factory)

    table_runtime = make_runtime("state_plane").initialize()
    view_runtime = make_runtime("state_view").initialize()
    service = Service(table_runtime, "session_table")

    lease = config.lease_time
    touch_spacing = 0.6 * lease
    lifetime = lease + config.touches * touch_spacing
    # rate targets `target` CONCURRENT sessions at steady state
    # (Little's law: N = λ·lifetime), compensated for the flood
    # tenant's arrivals being mostly shed at its budget
    total_weight = sum(t.weight for t in config.tenants)
    admitted_fraction = sum(t.weight for t in config.tenants
                            if not t.flood) / total_weight
    rate = 1.05 * target / lifetime / max(admitted_fraction, 0.1)

    # the flood tenant's budget is sized to be breached at EVERY rung:
    # its fair share of arrivals far exceeds both caps, so shed (count)
    # and demote (bytes) verdicts must both fire
    flood_names = [t.name for t in config.tenants if t.flood]
    budgets = {name: TenantBudget(
        max_sessions=max(16, target // 50),
        max_bytes=max(16, target // 50) * config.payload_bytes // 2)
        for name in flood_names}

    expired_batches = []
    table = SessionTable(
        service, num_shards=config.num_shards, lease_time=lease,
        wheel_tick=config.tick, budgets=budgets,
        snapshot_interval=config.snapshot_interval,
        on_expired=lambda keys: expired_batches.append(len(keys)))
    view = SessionView(view_runtime, service.topic_path,
                       config.num_shards, tenants=config.view_tenant)
    view_deltas = [0]
    view.add_handler(lambda *_: view_deltas.__setitem__(
        0, view_deltas[0] + 1))

    names = [t.name for t in config.tenants]
    weights = [t.weight for t in config.tenants]
    payload = "x" * config.payload_bytes
    state = _Lifecycle()

    def arrive():
        state.counter += 1
        tenant = rng.choices(names, weights)[0]
        sid = f"s{state.counter}"
        if not table.create(tenant, sid, payload):
            bucket = state.create_failures
            bucket[tenant] = bucket.get(tenant, 0) + 1
            return
        if state.counter % 4 == 0:
            # every 4th session mutates its payload mid-life: the
            # update leg of the lifecycle (delta publish + budget
            # re-check) rides the same wheel-driven schedule
            engine.add_oneshot_handler(
                (lambda t=tenant, s=sid:
                 table.update(t, s, payload + "u")),
                0.3 * touch_spacing)
        for k in range(1, config.touches + 1):
            engine.add_oneshot_handler(
                (lambda t=tenant, s=sid: table.touch(t, s)),
                k * touch_spacing)
            state.touches_scheduled += 1

    def drive(duration: float, arrivals: bool) -> None:
        clock = engine.clock
        end = clock.now() + duration
        next_arrival = clock.now() + (rng.expovariate(rate)
                                      if arrivals else float("inf"))
        while clock.now() < end:
            if arrivals:
                now = clock.now()
                while next_arrival <= now:
                    arrive()
                    next_arrival += rng.expovariate(rate)
            while engine.step():
                pass
            state.peak_sessions = max(state.peak_sessions, len(table))
            clock.advance(config.tick)

    probe = _HandlerLatencyProbe()
    stats_before = dict(table.stats)
    delta_before = table.delta_bytes()
    wall_start = time.perf_counter()

    drive(lifetime, arrivals=True)           # ramp to steady state
    steady_sessions = len(table)
    measure_virtual = lease
    drive(measure_virtual, arrivals=True)    # hold at steady state
    measured = probe.delta()
    # drain: stop arrivals, let every outstanding lease lapse (final
    # touches land within `lifetime`, plus one lease after the last)
    drive(lifetime + lease + 1.0, arrivals=False)
    wall_s = time.perf_counter() - wall_start

    stats = {k: table.stats.get(k, 0) - stats_before.get(k, 0)
             for k in ("created", "touched", "updated", "expired",
                       "shed", "demoted")}
    churn = stats["touched"] + stats["expired"]
    leaked_sessions = len(table)
    leaked_table_timers = table.outstanding_timers()
    view.terminate()
    table.stop()
    while engine.step():                    # deliver teardown messages
        pass
    leaked_engine_timers = len(engine.live_timer_handlers())
    table_runtime.terminate()
    view_runtime.terminate()

    per_tenant = {name: {"shed": state.create_failures.get(name, 0)}
                  for name in names}

    ops = stats["created"] + stats["touched"] + stats["expired"] \
        + stats["updated"]
    return {
        "target": target,
        "steady_sessions": steady_sessions,
        "peak_sessions": state.peak_sessions,
        "wall_s": round(wall_s, 3),
        "ops": ops,
        "ops_per_wall_s": round(ops / wall_s, 1) if wall_s else 0.0,
        "sessions_per_wall_s": round(stats["created"] / wall_s, 1)
        if wall_s else 0.0,
        "lease_churn_per_virtual_s": round(
            churn / (lifetime + measure_virtual), 1),
        "delta_bytes": table.delta_bytes() - delta_before,
        "handler_p95_ms": measured["p95_ms"],
        "handler_mean_us": measured["mean_us"],
        "handler_count": measured["count"],
        "expiry_batches": len(expired_batches),
        "max_expiry_batch": max(expired_batches, default=0),
        "view_deltas": view_deltas[0],
        "stats": stats,
        "per_tenant": per_tenant,
        "leaked_sessions": leaked_sessions,
        "leaked_timers": leaked_table_timers + leaked_engine_timers,
    }


def run_session_load(config: LoadConfig | None = None) -> dict:
    """Run every rung; returns the full report with pass/fail verdicts:
    `flat` (no O(n) knee in handler p95 across rungs), `budgets`
    (flooding tenant shed AND demoted, polite tenants untouched),
    `drain` (zero leaked sessions/timers everywhere), and the overall
    `ok`."""
    config = config or LoadConfig()
    rng = random.Random(config.seed)
    rungs = [_run_rung(config, target, rng)
             for target in sorted(config.rungs)]

    first, last = rungs[0], rungs[-1]
    # flatness on the p95 (log2-bucketed: a ratio of 4 = two buckets);
    # guard the degenerate all-sub-bucket case with the mean
    p95_ratio = (last["handler_p95_ms"] / first["handler_p95_ms"]) \
        if first["handler_p95_ms"] else 1.0
    flat_ok = p95_ratio <= config.max_p95_ratio
    flood_names = {t.name for t in config.tenants if t.flood}
    flood_shed = sum(r["stats"]["shed"] for r in rungs)
    flood_demoted = sum(r["stats"]["demoted"] for r in rungs)
    polite_shed = sum(
        r["per_tenant"][name]["shed"]
        for r in rungs for name in r["per_tenant"]
        if name not in flood_names)
    budgets_ok = flood_shed > 0 and flood_demoted > 0 \
        and polite_shed == 0
    leaked_sessions = sum(r["leaked_sessions"] for r in rungs)
    leaked_timers = sum(r["leaked_timers"] for r in rungs)
    drain_ok = leaked_sessions == 0 and leaked_timers == 0
    sustained = last["steady_sessions"]
    report = {
        "seed": config.seed,
        "lease_time": config.lease_time,
        "touches": config.touches,
        "num_shards": config.num_shards,
        "rungs": rungs,
        "sustained_sessions": sustained,
        "flat": {"p95_ratio": round(p95_ratio, 3),
                 "max_p95_ratio": config.max_p95_ratio,
                 "ok": flat_ok},
        "budgets": {"flood_shed": flood_shed,
                    "flood_demoted": flood_demoted,
                    "polite_shed": polite_shed,
                    "ok": budgets_ok},
        "drain": {"leaked_sessions": leaked_sessions,
                  "leaked_timers": leaked_timers,
                  "ok": drain_ok},
    }
    report["ok"] = flat_ok and budgets_ok and drain_ok
    return report
