# Autoscaler: metrics-driven elastic capacity for serving runtimes.
#
# The port's own copy of aiko_services_tpu/autoscaler.py.  Every process
# publishes retained metrics snapshots on {topic_path}/0/metrics
# (observe/export.py MetricsPublisher) and the LifeCycleManager
# supervises a fleet under a RestartPolicy.  This actor closes the loop:
# it subscribes to the namespace's metrics topics, appends them into a
# SeriesStore (observe/series.py), extracts the load signals (event
# mailbox depth and its trend, windowed remote-hop p95, batch-former
# wait, admission queue depth, and, when a policy arms them, the
# fleet-merged TTFT / ITL p95, prefill queue depth, KV pool occupancy
# and host-tier pressure) and scales the fleet through
# LifeCycleManager.scale_to with hysteresis:
#
#   * scale up when any signal has breached its up-threshold for
#     `hysteresis` consecutive evaluations;
#   * scale down when every signal has stayed below its down-threshold
#     over the whole window for `hysteresis` consecutive evaluations;
#   * restore the floor at once: a fleet below min_clients respawns on
#     the next evaluation without waiting out the streak;
#   * a cooldown after every action lets the new capacity's metrics
#     arrive before the next verdict.
#
# A shrink retires clients through the drain route ((control_drain N) to
# each victim) when drain_s is set; without it, a shrink whose fleet
# still reports live decode slots is refused.  Decisions are counted in
# autoscaler_decisions_total{action, reason}, mirrored into gauges, and
# recorded as tracer spans when tracing is enabled.

from __future__ import annotations

import time
from dataclasses import dataclass

from .actor import Actor
from .observe import tracing
from .observe.export import METRICS_TOPIC_SUFFIX, parse_retained_json
from .observe.metrics import default_registry
from .observe.series import HistogramSeries, ScalarSeries, SeriesStore
from .service import ServiceProtocol
from .utils import get_logger

__all__ = ["Autoscaler", "ScalePolicy", "PROTOCOL_AUTOSCALER"]

PROTOCOL_AUTOSCALER = ServiceProtocol("autoscaler")

# series families the scale loop reads — the intake appends only these
# (the aggregator keeps full history; the autoscaler needs four, plus
# the serving TTFT sketches only when the policy arms that signal —
# retaining sketch payloads nobody reads would cost per-snapshot copies
# scaling with fleet size)
_SIGNAL_FAMILIES = ("event_mailbox_depth", "pipeline_hop_seconds",
                    "batch_mean_wait_ms", "admission_queue_depth",
                    "prefill_queue_depth", "serving_active_slots")


@dataclass(frozen=True)
class ScalePolicy:
    """Thresholds and pacing for the scale loop.  Up-thresholds trip on
    ANY signal; down-thresholds require ALL signals quiet."""
    min_clients: int = 1
    max_clients: int = 4
    mailbox_depth_up: float = 64.0      # queued events, worst process
    hop_p95_up: float = 1.0             # seconds, pipeline_hop_seconds
    batch_wait_up: float = 100.0        # ms, batch_mean_wait_ms
    # frames queued in the admission fair queue (worst tenant) — the
    # serving-side backlog the overload plane sheds from (the fair
    # queue's own pressure is a first-class scale signal)
    queue_depth_up: float = 256.0
    mailbox_depth_down: float = 4.0
    hop_p95_down: float = 0.25
    batch_wait_down: float = 20.0
    queue_depth_down: float = 8.0
    # leading-edge signal: worst mailbox-depth SLOPE (events/second
    # over the window) that votes overload.  None = level-only; a
    # ramp that will cross mailbox_depth_up
    # in a few windows can then add capacity before it does.
    mailbox_trend_up: float | None = None
    # fleet-true TTFT p95 (seconds) from the MERGED serving sketches:
    # unlike every other signal this is not worst-of-
    # process — the store merges each runtime's windowed delta sketch,
    # so the autoscaler scales on the latency the fleet actually
    # served.  None = signal off.
    ttft_p95_up: float | None = None
    ttft_p95_down: float = 0.05
    # per-role pool signals:
    # a PREFILL-pool autoscaler arms prefill_queue_up (worst
    # prefill_queue_depth gauge — prompts waiting for KV compute, the
    # TTFT backlog) and usually ttft_p95_up; a DECODE-pool autoscaler
    # arms itl_p95_up (fleet-merged serving_itl_seconds sketch — the
    # number a prefill burst dilates) beside its batch-wait signals.
    # Both default OFF so existing single-pool policies are unchanged.
    prefill_queue_up: float | None = None
    prefill_queue_down: float = 1.0
    itl_p95_up: float | None = None
    itl_p95_down: float = 0.005
    # capacity-pressure signals: worst
    # KV block-pool occupancy fraction (kv_pool_occupancy gauge) and
    # worst host-tier pressure (kv_ledger_host_pressure — host store
    # bytes_used/max_bytes).  A fleet near pool exhaustion preempts
    # and sheds long before latency signals notice; host pressure
    # rising means demoted prefixes are about to start falling off the
    # bottom tier.  Both default OFF.
    pool_occupancy_up: float | None = None
    pool_occupancy_down: float = 0.25
    host_pressure_up: float | None = None
    host_pressure_down: float = 0.25
    # staleness/evidence window: a process silent longer than this
    # stops voting (replaces the old _SNAPSHOT_HORIZON), and the
    # underload veto considers the window's worst value
    window: float = 30.0
    hysteresis: int = 3                 # consecutive breaching evals
    cooldown: float = 10.0              # seconds between scale actions
    step: int = 1                       # clients added/removed per action


class Autoscaler(Actor):
    """Watches retained {topic}/0/metrics snapshots and drives a
    LifeCycleManager's fleet size.

    `manager` is the LifeCycleManager whose spawner builds one serving
    runtime per client (under its RestartPolicy — the autoscaler and
    the crash supervisor share one actuator, so they cannot fight over
    the same fleet).  `topic_filter` defaults to every process in the
    runtime's namespace; narrow it when several fleets share a
    namespace."""

    def __init__(self, runtime, name: str = "autoscaler", manager=None,
                 policy: ScalePolicy | None = None,
                 interval: float = 2.0, topic_filter: str | None = None,
                 drain_s: float | None = None):
        super().__init__(runtime, name, PROTOCOL_AUTOSCALER)
        self.logger = get_logger(f"autoscaler.{name}")
        self.manager = manager
        self.policy = policy or ScalePolicy()
        self.interval = float(interval)
        # graceful-drain arming: with drain_s set, every
        # shrink routes through LifeCycleManager.scale_to(...,
        # drain_s=) — retired runtimes drain and migrate instead of
        # being killed.  Unarmed, a shrink whose victims still report
        # live decode slots (the serving_active_slots gauge) is
        # REFUSED and counted rather than dropping that work.
        self.drain_s = None if drain_s is None else float(drain_s)
        # topic_path is {namespace}/{host}/{pid}; metrics snapshots ride
        # {topic_path}/0/metrics
        self._filter = topic_filter or \
            f"{runtime.namespace}/+/+/{METRICS_TOPIC_SUFFIX}"
        # windowed series history: the store's window doubles
        # as the staleness horizon and its prune() as the corpse
        # collection the old snapshot dict did by hand
        self.store = SeriesStore(window=self.policy.window)
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at: float | None = None
        registry = default_registry()
        labels = {"autoscaler": name}
        self._decision_counters: dict = {}
        self._registry = registry
        self._labels = labels
        self._clients_gauge = registry.gauge(
            "autoscaler_clients", "fleet size the autoscaler manages",
            labels)
        self._signal_gauges = {
            "mailbox_depth": registry.gauge(
                "autoscaler_signal_mailbox_depth",
                "worst observed event mailbox depth", labels),
            "hop_p95": registry.gauge(
                "autoscaler_signal_hop_p95_s",
                "worst windowed remote-hop p95 seconds", labels),
            "batch_wait": registry.gauge(
                "autoscaler_signal_batch_wait_ms",
                "worst observed batch-former mean wait ms", labels),
            "mailbox_trend": registry.gauge(
                "autoscaler_signal_mailbox_trend",
                "worst mailbox-depth slope (events/s over the window)",
                labels),
            "queue_depth": registry.gauge(
                "autoscaler_signal_queue_depth",
                "worst admission fair-queue depth", labels),
            "ttft_p95": registry.gauge(
                "autoscaler_signal_ttft_p95_s",
                "fleet-merged serving TTFT p95 seconds (sketch)",
                labels),
            "prefill_queue": registry.gauge(
                "autoscaler_signal_prefill_queue",
                "worst prefill-runtime queue depth", labels),
            "itl_p95": registry.gauge(
                "autoscaler_signal_itl_p95_s",
                "fleet-merged serving ITL p95 seconds (sketch)",
                labels),
            "pool_occupancy": registry.gauge(
                "autoscaler_signal_pool_occupancy",
                "worst KV block-pool occupancy fraction", labels),
            "host_pressure": registry.gauge(
                "autoscaler_signal_host_pressure",
                "worst host KV tier pressure (bytes_used/max_bytes)",
                labels),
        }
        self._families = set(_SIGNAL_FAMILIES)
        if self.policy.ttft_p95_up is not None:
            self._families.add("serving_ttft_seconds")
        if self.policy.itl_p95_up is not None:
            self._families.add("serving_itl_seconds")
        if self.policy.pool_occupancy_up is not None:
            self._families.add("kv_pool_occupancy")
        if self.policy.host_pressure_up is not None:
            self._families.add("kv_ledger_host_pressure")
        runtime.add_message_handler(self._metrics_handler, self._filter)
        self._timer = runtime.event.add_timer_handler(self.evaluate,
                                                      self.interval)

    # -- snapshot intake ----------------------------------------------------
    def _metrics_handler(self, topic: str, payload) -> None:
        document = parse_retained_json(payload, require_key="snapshot")
        if document is None:
            self.logger.debug("autoscaler %s: unparseable snapshot on "
                              "%s", self.name, topic)
            return
        self.store.append_snapshot(
            str(document.get("topic_path", topic)),
            document["snapshot"], self.runtime.event.clock.now(),
            families=self._families)

    # -- signal extraction --------------------------------------------------
    def _worst(self, family: str, read,
               kind: type = ScalarSeries) -> float:
        """Worst value of `read(ring)` across a family's rings, rings
        of the wrong series kind skipped: the store is fed from
        NETWORK-received snapshots, and a foreign/cross-version
        publisher shipping a family under the other metric type must
        not crash every evaluate tick with an AttributeError."""
        worst = 0.0
        for _, ring in self.store.rings(family):
            if not isinstance(ring, kind):
                continue
            value = read(ring)
            if value is not None:
                worst = max(worst, float(value))
        return worst

    def signals(self) -> dict:
        """Worst-case load signals across every process with evidence
        inside the policy window: levels read the LATEST sample (a
        silent process stops voting once its history ages out — the
        store's window IS the staleness horizon), hop p95 is the
        windowed delta-quantile, and mailbox_trend is the worst
        depth slope in events/second (the leading-edge signal)."""
        now = self.runtime.event.clock.now()
        window = self.policy.window
        self.store.prune(now)
        return {
            "mailbox_depth": self._worst(
                "event_mailbox_depth",
                lambda r: r.latest(now, window)),
            # baseline_empty: the FIRST snapshot a process ever sends
            # reports everything its cumulative histogram holds — one
            # sample is still evidence for capacity decisions (unlike
            # SLO alerting, which demands a real delta)
            "hop_p95": self._worst(
                "pipeline_hop_seconds",
                lambda r: r.delta_quantile(0.95, now, window,
                                           baseline_empty=True),
                kind=HistogramSeries),
            "batch_wait": self._worst(
                "batch_mean_wait_ms",
                lambda r: r.latest(now, window)),
            "mailbox_trend": self._worst(
                "event_mailbox_depth",
                lambda r: r.trend(now, window)),
            "queue_depth": self._worst(
                "admission_queue_depth",
                lambda r: r.latest(now, window)),
            "ttft_p95": self._merged_p95(
                "serving_ttft_seconds", self.policy.ttft_p95_up,
                now, window),
            "prefill_queue": self._worst(
                "prefill_queue_depth",
                lambda r: r.latest(now, window)),
            "itl_p95": self._merged_p95(
                "serving_itl_seconds", self.policy.itl_p95_up,
                now, window),
            "pool_occupancy": self._worst(
                "kv_pool_occupancy",
                lambda r: r.latest(now, window)),
            "host_pressure": self._worst(
                "kv_ledger_host_pressure",
                lambda r: r.latest(now, window)),
        }

    def _merged_p95(self, family: str, armed: float | None,
                    now: float, window: float) -> float:
        """Quantile of a CROSS-SOURCE merged windowed sketch family —
        fleet-true, not worst-of (the TTFT family, and the ITL family
        for the decode pool).  baseline_empty for the same
        reason as hop_p95: one snapshot is still capacity evidence.
        Computed only when the policy USES the signal (`armed` set) —
        reconstructing and merging every source's delta sketch per
        evaluate tick is not free, and the default policy ignores the
        result."""
        if armed is None:
            return 0.0
        merged = self.store.merged_sketch(
            family, now, window, baseline_empty=True)
        value = merged.quantile(0.95) if merged is not None else None
        return float(value) if value is not None else 0.0

    def _windowed_quiet(self, signals: dict, now: float) -> bool:
        """The underload veto reads the window's WORST values, not the
        latest tick: capacity shrinks only when the whole window was
        quiet — a spike two evaluations ago still blocks the shrink
        (shrinking is cheap to delay, expensive to regret)."""
        policy = self.policy
        window = policy.window
        worst_mailbox = self._worst("event_mailbox_depth",
                                    lambda r: r.maximum(now, window))
        worst_batch = self._worst("batch_mean_wait_ms",
                                  lambda r: r.maximum(now, window))
        worst_queue = self._worst("admission_queue_depth",
                                  lambda r: r.maximum(now, window))
        worst_prefill = self._worst("prefill_queue_depth",
                                    lambda r: r.maximum(now, window))
        worst_occupancy = self._worst("kv_pool_occupancy",
                                      lambda r: r.maximum(now, window))
        worst_host = self._worst("kv_ledger_host_pressure",
                                 lambda r: r.maximum(now, window))
        return (worst_mailbox <= policy.mailbox_depth_down
                and signals["hop_p95"] <= policy.hop_p95_down
                and worst_batch <= policy.batch_wait_down
                and worst_queue <= policy.queue_depth_down
                and (policy.ttft_p95_up is None
                     or signals["ttft_p95"] <= policy.ttft_p95_down)
                and (policy.prefill_queue_up is None
                     or worst_prefill <= policy.prefill_queue_down)
                and (policy.itl_p95_up is None
                     or signals["itl_p95"] <= policy.itl_p95_down)
                and (policy.pool_occupancy_up is None
                     or worst_occupancy <= policy.pool_occupancy_down)
                and (policy.host_pressure_up is None
                     or worst_host <= policy.host_pressure_down))

    # -- the scale loop -----------------------------------------------------
    def _count_decision(self, action: str, reason: str) -> None:
        key = (action, reason)
        counter = self._decision_counters.get(key)
        if counter is None:
            counter = self._registry.counter(
                "autoscaler_decisions_total",
                "scale loop verdicts by action and reason",
                labels={**self._labels, "action": action,
                        "reason": reason})
            self._decision_counters[key] = counter
        counter.inc()

    def _in_cooldown(self, now: float) -> bool:
        return self._last_action_at is not None and \
            now - self._last_action_at < self.policy.cooldown

    def live_slots(self) -> float:
        """Worst serving_active_slots gauge (live decode slots +
        queued requests) across every process with evidence inside
        the policy window — the shrink-safety signal.  0.0 when no
        decoder publishes the gauge (non-serving fleets shrink
        unconditionally)."""
        now = self.runtime.event.clock.now()
        return self._worst("serving_active_slots",
                           lambda r: r.latest(now, self.policy.window))

    def _act(self, delta: int, reason: str, now: float,
             signals: dict) -> None:
        action = "up" if delta > 0 else "down"
        target = len(self.manager.clients) + delta
        target = min(max(target, 0), self.policy.max_clients)
        if delta < 0:
            # a step larger than the headroom must not shrink below
            # the floor — it would trigger a below-floor respawn next
            # tick and flap forever
            target = max(target, self.policy.min_clients)
            live = self.live_slots()
            if live > 0 and self.drain_s is None:
                # a shrink must not kill the newest-first victim's
                # live generations cold: without drain armed it is
                # refused (and counted) until the fleet reports zero
                # live slots
                self._count_decision("hold", "in-flight")
                self.logger.warning(
                    "autoscaler %s: shrink refused — %d live slot(s) "
                    "reported and drain is not armed", self.name,
                    int(live))
                return
        started = time.perf_counter()
        if delta < 0 and self.drain_s is not None:
            applied = self.manager.scale_to(target,
                                            drain_s=self.drain_s)
        else:
            applied = self.manager.scale_to(target)
        if applied == 0:
            return
        self._last_action_at = now
        self._up_streak = 0
        self._down_streak = 0
        self._count_decision(action, reason)
        self.logger.warning(
            "autoscaler %s: scale %s (%+d -> %d clients, reason=%s, "
            "signals=%s)", self.name, action, applied,
            len(self.manager.clients), reason,
            {k: round(v, 3) for k, v in signals.items()})
        trc = tracing.tracer
        if trc.enabled:
            trc.record(f"autoscale:{action}", started,
                       time.perf_counter() - started,
                       context=tracing.new_trace(), cat="autoscale",
                       proc=self.name,
                       args={"reason": reason, "delta": applied,
                             **{k: round(v, 4)
                                for k, v in signals.items()}})

    def evaluate(self) -> None:
        """One scale-loop tick (engine timer, so virtual-clock tests
        drive it deterministically)."""
        if self.manager is None:
            return
        policy = self.policy
        now = self.runtime.event.clock.now()
        signals = self.signals()
        self._signal_gauges["mailbox_depth"].set(
            signals["mailbox_depth"])
        self._signal_gauges["hop_p95"].set(signals["hop_p95"])
        self._signal_gauges["batch_wait"].set(signals["batch_wait"])
        self._signal_gauges["mailbox_trend"].set(
            signals["mailbox_trend"])
        self._signal_gauges["queue_depth"].set(signals["queue_depth"])
        self._signal_gauges["ttft_p95"].set(signals["ttft_p95"])
        self._signal_gauges["prefill_queue"].set(
            signals["prefill_queue"])
        self._signal_gauges["itl_p95"].set(signals["itl_p95"])
        self._signal_gauges["pool_occupancy"].set(
            signals["pool_occupancy"])
        self._signal_gauges["host_pressure"].set(
            signals["host_pressure"])
        total = len(self.manager.clients)
        self._clients_gauge.set(total)

        # floor restoration needs no hysteresis: lost capacity (a crash
        # the restart supervisor gave up on, a slow respawn) is not a
        # noisy signal — but it still honours the cooldown, or a
        # handshaking replacement would be double-spawned every tick
        if total < policy.min_clients:
            if not self._in_cooldown(now):
                self._act(policy.min_clients - total, "below-floor",
                          now, signals)
            return
        overload = (
            signals["mailbox_depth"] >= policy.mailbox_depth_up
            or signals["hop_p95"] >= policy.hop_p95_up
            or signals["batch_wait"] >= policy.batch_wait_up
            or signals["queue_depth"] >= policy.queue_depth_up
            or (policy.mailbox_trend_up is not None
                and signals["mailbox_trend"] >=
                policy.mailbox_trend_up)
            or (policy.ttft_p95_up is not None
                and signals["ttft_p95"] >= policy.ttft_p95_up)
            or (policy.prefill_queue_up is not None
                and signals["prefill_queue"] >= policy.prefill_queue_up)
            or (policy.itl_p95_up is not None
                and signals["itl_p95"] >= policy.itl_p95_up)
            or (policy.pool_occupancy_up is not None
                and signals["pool_occupancy"] >=
                policy.pool_occupancy_up)
            or (policy.host_pressure_up is not None
                and signals["host_pressure"] >= policy.host_pressure_up))
        underload = not overload and self._windowed_quiet(signals, now)
        if overload:
            self._up_streak += 1
            self._down_streak = 0
        elif underload:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # the dead band between the thresholds: this is what
            # absorbs a threshold-straddling load step — neither streak
            # may keep growing on ambiguous evidence
            self._up_streak = 0
            self._down_streak = 0
            self._count_decision("hold", "dead-band")
            return
        if self._in_cooldown(now):
            self._count_decision("hold", "cooldown")
            return
        if overload and self._up_streak >= policy.hysteresis:
            if total < policy.max_clients:
                self._act(policy.step, "overload", now, signals)
            else:
                self._count_decision("hold", "at-max")
        elif underload and self._down_streak >= policy.hysteresis:
            if total > policy.min_clients:
                self._act(-policy.step, "underload", now, signals)
            else:
                self._count_decision("hold", "at-min")

    def stop(self) -> None:
        if self._timer is not None:
            self.runtime.event.remove_timer_handler(self._timer)
            self._timer = None
        self.runtime.remove_message_handler(self._metrics_handler,
                                            self._filter)
        super().stop()
