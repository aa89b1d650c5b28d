# Overload control for serving runtimes: deadline-aware admission and
# per-tenant weighted fair queuing.
#
# The port's own copy of aiko_services_tpu/ops/admission.py (host code,
# no device work):
#
#   * shed EARLY, at the cheapest point: a request whose remaining
#     deadline budget cannot survive the estimated queue wait is
#     answered with a failure reply IMMEDIATELY (one dedup-cached
#     control message), so the caller fails over to another candidate
#     instead of burning broker round-trips on doomed work;
#   * isolate tenants: a weighted deficit-round-robin queue in front of
#     the walk gives each tenant a budget per priority tier; overload
#     sheds newest-first WITHIN the over-budget tenant only;
#   * make every verdict observable: admission_{admitted,shed,rejected}
#     _total{tenant,tier,reason} counters and per-tenant queue-depth
#     gauges, under the JAX package's family names.
#
# The module is transport-free: the Pipeline serving entry
# (pipeline.process_frame_remote) plugs in its own dispatch/shed
# callables.  The byte verdict (set_byte_policy / shed_on_bytes) sheds a
# tenant whose KV ledger balance would pass its byte budget.

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable

from ..observe.metrics import MetricsRegistry, default_registry

__all__ = ["TenantPolicy", "TenantFairQueue", "AdmissionGate",
           "DeadlineRouter", "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant fair-queuing knobs.

    weight:       DRR quantum share within the tenant's tier (2.0
                  drains twice as fast as 1.0 under contention);
    tier:         strict priority band — tier 0 drains before tier 1
                  has any items dispatched, and so on;
    queue_budget: max frames this tenant may have queued (None → the
                  queue's base_budget × weight)."""
    weight: float = 1.0
    tier: int = 1
    queue_budget: int | None = None


@dataclass
class _TenantState:
    name: str
    policy: TenantPolicy
    items: deque            # (item, shed_callable, cost, enqueued_t)
    deficit: float = 0.0
    depth_gauge: object = None


class TenantFairQueue:
    """Weighted deficit-round-robin admission queue.

    submit() enqueues one item under its tenant (shedding when the
    tenant is over budget); drain(dispatch) releases items in strict
    tier order, DRR-weighted within a tier, calling dispatch(item) for
    each.  Items carry a shed callable so a dropped frame can still
    answer its caller (the serving dedup ring depends on every hop
    getting a reply)."""

    def __init__(self, policies: dict | None = None,
                 default_policy: TenantPolicy | None = None,
                 base_budget: int = 32,
                 global_budget: int | None = None,
                 quantum: float = 1.0,
                 registry: MetricsRegistry | None = None,
                 metrics_labels: dict | None = None,
                 clock: Callable | None = None):
        self._policies = dict(policies or {})
        self._default_policy = default_policy or TenantPolicy()
        self.base_budget = max(1, int(base_budget))
        # global cap across tenants: breach sheds from the MOST
        # over-budget tenant (queued ÷ weight), never from a polite one
        self.global_budget = int(global_budget) if global_budget else None
        self.quantum = float(quantum)
        self._tenants: dict[str, _TenantState] = {}
        self._registry = registry or default_registry()
        self._labels = dict(metrics_labels or {})
        self._counter_cache: dict = {}
        # MEASURED per-tenant queue dwell: with a clock
        # (callable → seconds; the pipeline passes the engine clock so
        # virtual-clock tests stay deterministic) every drained item
        # observes (dispatch - enqueue) into
        # admission_queue_wait_seconds{tenant} — the number the
        # request journey records, where the gate's estimated_wait is
        # only a forecast.  last_dispatch_wait exposes the most recent
        # measurement to the dispatch callback (drain calls dispatch
        # synchronously right after observing), so callers record ONE
        # dwell, not a parallel re-measurement.
        self._clock = clock
        self._wait_histograms: dict = {}
        self.last_dispatch_wait: float | None = None

    def set_clock(self, clock: Callable) -> None:
        """Install a dwell clock unless the queue was made with one —
        how the Pipeline hands its engine clock to an externally
        constructed gate."""
        if self._clock is None:
            self._clock = clock

    # -- metrics -----------------------------------------------------------
    def _count(self, family: str, tenant: str, tier: int,
               reason: str) -> None:
        key = (family, tenant, tier, reason)
        counter = self._counter_cache.get(key)
        if counter is None:
            counter = self._registry.counter(
                f"admission_{family}_total",
                f"admission verdicts: frames {family}",
                labels={**self._labels, "tenant": tenant,
                        "tier": str(tier), "reason": reason})
            self._counter_cache[key] = counter
        counter.inc()

    def _state(self, tenant: str, tier: int | None) -> _TenantState:
        state = self._tenants.get(tenant)
        if state is None:
            policy = self._policies.get(tenant, self._default_policy)
            if tier is not None and tenant not in self._policies:
                # caller-declared tier honoured only for tenants the
                # serving side has no explicit policy for
                policy = TenantPolicy(policy.weight, int(tier),
                                      policy.queue_budget)
            state = _TenantState(tenant, policy, deque())
            state.depth_gauge = self._registry.gauge(
                "admission_queue_depth",
                "frames queued per tenant awaiting admission",
                labels={**self._labels, "tenant": tenant,
                        "tier": str(policy.tier)})
            self._tenants[tenant] = state
        return state

    def _budget(self, state: _TenantState) -> int:
        if state.policy.queue_budget is not None:
            return max(1, int(state.policy.queue_budget))
        return max(1, int(self.base_budget * state.policy.weight))

    # -- enqueue / shed ----------------------------------------------------
    def submit(self, tenant: str, item, shed: Callable | None = None,
               tier: int | None = None, cost: float = 1.0) -> bool:
        """Queue one item; returns False when it was shed instead.
        Shedding is newest-first within the offending tenant only: the
        incoming frame IS the newest, so an over-budget tenant loses it
        (and, on a global-budget breach, the most over-budget tenant
        loses its own newest queued frame)."""
        tenant = str(tenant or DEFAULT_TENANT)
        state = self._state(tenant, tier)
        if len(state.items) >= self._budget(state):
            self._count("shed", tenant, state.policy.tier,
                        "tenant-over-budget")
            if shed is not None:
                shed(item)
            return False
        state.items.append((item, shed, float(cost),
                            self._clock() if self._clock is not None
                            else None))
        state.depth_gauge.set(len(state.items))
        if self.global_budget is not None and \
                self.depth() > self.global_budget:
            return self._shed_most_over_budget() is not item
        return True

    def _shed_most_over_budget(self):
        """Shed (and return) the newest queued item of the tenant most
        over its weighted share; None when nothing is queued."""
        worst, worst_ratio = None, -1.0
        for tenant, state in self._tenants.items():
            if not state.items:
                continue
            ratio = len(state.items) / max(state.policy.weight, 1e-9)
            if ratio > worst_ratio:
                worst, worst_ratio = tenant, ratio
        if worst is None:
            return None
        state = self._tenants[worst]
        item, shed, _, _ = state.items.pop()       # newest-first
        state.depth_gauge.set(len(state.items))
        self._count("shed", worst, state.policy.tier,
                    "global-over-budget")
        if shed is not None:
            shed(item)
        return item

    # -- drain -------------------------------------------------------------
    def drain(self, dispatch: Callable, limit: int | None = None) -> int:
        """Release up to `limit` items (None = everything eligible):
        strict tier priority, weighted DRR within each tier.  Returns
        the number dispatched."""
        released = 0
        tiers = sorted({s.policy.tier for s in self._tenants.values()
                        if s.items})
        for tier in tiers:
            while limit is None or released < limit:
                states = [s for s in self._tenants.values()
                          if s.items and s.policy.tier == tier]
                if not states:
                    break
                progressed = False
                for state in states:
                    if limit is not None and released >= limit:
                        break
                    state.deficit += self.quantum * state.policy.weight
                    while state.items and \
                            state.deficit >= state.items[0][2] and \
                            (limit is None or released < limit):
                        item, _, cost, enqueued_t = \
                            state.items.popleft()
                        state.deficit -= cost
                        state.depth_gauge.set(len(state.items))
                        self._count("admitted", state.name,
                                    state.policy.tier, "queued")
                        if enqueued_t is not None:
                            self._observe_wait(state.name,
                                               enqueued_t)
                        else:
                            self.last_dispatch_wait = None
                        dispatch(item)
                        released += 1
                        progressed = True
                    if not state.items:
                        state.deficit = 0.0     # DRR: idle tenants
                                                # bank no credit
                if not progressed:
                    break
        return released

    def _observe_wait(self, tenant: str, enqueued_t: float) -> None:
        histogram = self._wait_histograms.get(tenant)
        if histogram is None:
            histogram = self._registry.histogram(
                "admission_queue_wait_seconds",
                "measured fair-queue dwell per drained frame",
                labels={**self._labels, "tenant": tenant})
            self._wait_histograms[tenant] = histogram
        wait = max(0.0, self._clock() - enqueued_t)
        self.last_dispatch_wait = wait
        histogram.observe(wait)

    def depth(self, tenant: str | None = None) -> int:
        if tenant is not None:
            state = self._tenants.get(str(tenant))
            return len(state.items) if state else 0
        return sum(len(s.items) for s in self._tenants.values())

    def shed_all(self, reason: str = "shutdown") -> int:
        """Drop every queued item through its shed callable (newest
        first) — teardown must answer queued callers, not orphan them."""
        count = 0
        for state in self._tenants.values():
            while state.items:
                item, shed, _, _ = state.items.pop()
                self._count("shed", state.name, state.policy.tier,
                            reason)
                if shed is not None:
                    shed(item)
                count += 1
            state.depth_gauge.set(0)
            state.deficit = 0.0
        return count


class DeadlineRouter:
    """Deadline-aware routing across role-tagged serving candidates
    (the disaggregated prefill/decode split).

    A prompt whose remaining deadline budget is SHORT goes to the
    LEAST-LOADED candidate — time-to-first-token is its binding
    constraint, and queueing behind a loaded prefill runtime is
    exactly the wait shed-early would later punish.  Prompts with
    ample (or no) budget round-robin so the pool shares work evenly
    and the load signal stays meaningful.

    Transport-free like the gate: callers hand in a {candidate: load}
    snapshot (e.g. a PrefillClient's per-runtime outstanding-transfer
    counts, or pipeline placeholder candidates filtered by role) and
    the remaining budget in seconds.  Verdicts mirror into
    admission_routes_total{router, verdict}."""

    def __init__(self, urgent_budget_s: float = 1.0,
                 name: str = "router",
                 registry: MetricsRegistry | None = None,
                 on_route=None):
        self.urgent_budget_s = float(urgent_budget_s)
        self.name = str(name)
        self._rr = 0
        self._registry = registry or default_registry()
        self._counters: dict = {}
        # on_route(candidate, remaining) fires on every successful
        # verdict — the next-hop seam: a tiered KV cache
        # hangs its promotion prefetch here so host-resident chains
        # start re-landing the moment a destination is KNOWN, not when
        # the routed work finally lands.  Failures are swallowed: a
        # prefetch hook must never turn a route into an exception.
        self.on_route = on_route

    def _count(self, verdict: str) -> None:
        counter = self._counters.get(verdict)
        if counter is None:
            counter = self._registry.counter(
                "admission_routes_total",
                "deadline-router verdicts by kind",
                labels={"router": self.name, "verdict": verdict})
            self._counters[verdict] = counter
        counter.inc()

    def route(self, loads: dict, remaining: float | None) -> str | None:
        """Pick one candidate from {candidate: load}; None when the
        pool is empty (the caller's fallback ladder takes over)."""
        if not loads:
            self._count("no-candidates")
            return None
        order = sorted(loads)           # deterministic tie-break
        if remaining is not None and remaining <= self.urgent_budget_s:
            self._count("urgent-least-loaded")
            choice = min(order,
                         key=lambda c: (float(loads[c] or 0.0), c))
        else:
            self._count("round-robin")
            choice = order[self._rr % len(order)]
            self._rr += 1
        if self.on_route is not None:
            try:
                self.on_route(choice, remaining)
            except Exception:
                pass
        return choice


class AdmissionGate:
    """Deadline-aware admission in front of a serving pipeline.

    Two verdicts, in order:

      1. shed-early — estimated_wait() (max over the registered wait
         estimators, e.g. BatchingScheduler.estimated_wait, falling
         back to the registry's batch_mean_wait_ms gauge) plus `margin`
         exceeds the request's remaining deadline budget → reject NOW
         with a failure reply, before any queueing;
      2. fair queue — admitted requests enter the per-tenant DRR queue
         and drain while fewer than `inflight_limit` admitted frames
         are outstanding (credits returned via release() when the
         serving reply goes out).

    The gate owns no transport and no clock: callers hand in remaining
    budget (seconds) and completion callbacks."""

    def __init__(self, queue: TenantFairQueue | None = None,
                 margin: float = 0.0, inflight_limit: int = 32,
                 registry: MetricsRegistry | None = None,
                 metrics_labels: dict | None = None):
        self._registry = registry or default_registry()
        self._labels = dict(metrics_labels or {})
        self.queue = queue if queue is not None else TenantFairQueue(
            registry=self._registry, metrics_labels=metrics_labels)
        self.margin = float(margin)
        self.inflight_limit = max(1, int(inflight_limit))
        self.inflight = 0
        self._estimators: list[Callable] = []
        # a watched decoder on a mesh sheds by deadline at its note
        self._decoder_sheds = False
        self._inflight_gauge = self._registry.gauge(
            "admission_inflight",
            "admitted frames awaiting their serving reply",
            labels=self._labels)

    # -- wait estimation ---------------------------------------------------
    def add_wait_estimator(self, estimator: Callable) -> None:
        """estimator() -> seconds | None; the gate uses the worst
        (largest) live estimate."""
        self._estimators.append(estimator)

    def watch_scheduler(self, scheduler) -> None:
        """Convenience: estimate from a BatchingScheduler's EWMA +
        occupancy (ops/batching.py estimated_wait)."""
        self.add_wait_estimator(scheduler.estimated_wait)

    def watch_decoder(self, decoder) -> None:
        """Convenience: estimate from a ContinuousDecoder's admit-wait
        heuristic (serving.py estimated_admit_wait).  A decoder on a
        mesh (one rank included) gives the estimate agreed in its last
        round note (rank 0's, agreed_admit_wait), and the gate then
        sheds nothing early by it: a gate on each rank, judging frames
        that reach the ranks at other moments, would hand the ranks
        different requests.  The request's deadline sheds it at the
        decoder's note instead (submit), by rank 0's verdict."""
        if getattr(decoder, "agreed", False):
            self._decoder_sheds = True
            self.add_wait_estimator(decoder.agreed_admit_wait)
            return
        self.add_wait_estimator(decoder.estimated_admit_wait)

    def estimated_wait(self) -> float | None:
        waits = []
        for estimator in self._estimators:
            try:
                wait = estimator()
            except Exception:
                continue
            if wait is not None:
                waits.append(float(wait))
        if waits:
            return max(waits)
        # fallback: the batch former's mean queue wait, as mirrored
        # into the registry (batch_mean_wait_ms gauge, any program)
        gauges = [m.value for _, m in
                  self._registry.series("batch_mean_wait_ms")]
        if gauges:
            return max(gauges) / 1000.0
        return None

    # -- verdicts ----------------------------------------------------------
    def shed_early(self, remaining: float | None):
        """(shed?, estimated_wait): True when the remaining deadline
        budget cannot survive the estimated queue wait.  A request with
        no deadline, or a gate with no wait signal, never sheds here —
        admission must not drop work on information it doesn't have.
        Nor does a gate that watches a decoder on a mesh (watch_decoder):
        the decoder sheds by the request's deadline at its round note."""
        wait = self.estimated_wait()
        if remaining is None or wait is None or self._decoder_sheds:
            return False, wait
        return (wait + self.margin) >= remaining, wait

    def count_rejected(self, tenant: str, tier: int, reason: str) -> None:
        """Mirror a rejection verdict the caller enforced (shed-early,
        already-expired) into the admission counter family."""
        self.queue._count("rejected", str(tenant or DEFAULT_TENANT),
                          int(tier), reason)

    # -- byte-budget verdict -----------------------------------------------
    def set_byte_policy(self, ledger, budget_bytes: int | None = None,
                        tenant_budgets: dict | None = None,
                        default_estimate: int = 0) -> None:
        """Arm capacity-aware shedding against a KV memory ledger.
        `budget_bytes` caps any one tenant's attributed device bytes
        (tenant_budgets overrides per tenant).  A request whose projected
        footprint (the tenant's ledger balance plus the per-request byte
        estimate) breaches its budget is shed unless the pool-wide
        occupancy trend relieves the overage inside the request's
        remaining deadline budget.  Disarmed (no ledger, or every budget
        None) the verdict never sheds."""
        self._byte_ledger = ledger
        self._byte_budget = None if budget_bytes is None \
            else int(budget_bytes)
        self._tenant_budgets = dict(tenant_budgets or {})
        self._byte_estimate = max(0, int(default_estimate))

    def shed_on_bytes(self, tenant: str, estimate_bytes: int | None = None,
                      remaining: float | None = None):
        """(shed?, projected_bytes): True when admitting `tenant`'s next
        request would breach its byte budget with no relief in sight.
        Callers reject with reason "byte-budget" via count_rejected."""
        ledger = getattr(self, "_byte_ledger", None)
        if ledger is None:
            return False, None
        key = str(tenant or DEFAULT_TENANT)
        budget = self._tenant_budgets.get(key, self._byte_budget)
        if budget is None:
            return False, None
        estimate = self._byte_estimate if estimate_bytes is None \
            else max(0, int(estimate_bytes))
        projected = int(ledger.device_bytes(key)) + estimate
        if projected <= budget:
            return False, projected
        trend = ledger.device_trend()
        if trend is not None and trend < 0 and remaining is not None:
            relief = (projected - budget) / -trend
            if relief < remaining:
                return False, projected
        return True, projected

    # -- fair-queue passage ------------------------------------------------
    def offer(self, tenant: str, item, shed: Callable | None = None,
              tier: int | None = None,
              dispatch: Callable | None = None) -> bool:
        """Queue one admitted request and drain what the inflight
        window allows.  Returns False when the fair queue shed it."""
        queued = self.queue.submit(tenant, item, shed=shed, tier=tier)
        if queued and dispatch is not None:
            self.drain(dispatch)
        return queued

    def drain(self, dispatch: Callable) -> int:
        budget = self.inflight_limit - self.inflight
        if budget <= 0:
            return 0

        def run(item):
            self.inflight += 1
            self._inflight_gauge.set(self.inflight)
            dispatch(item)

        return self.queue.drain(run, limit=budget)

    def release(self, count: int = 1) -> None:
        """An admitted frame completed (its reply went out): return its
        inflight credit.  The owner should drain() afterwards."""
        self.inflight = max(0, self.inflight - count)
        self._inflight_gauge.set(self.inflight)
