# Serving-plane fault injection.
#
# Counterpart of aiko_services_tpu/serving_chaos.py.  transport/chaos.py
# injects wire faults; this module injects the serving plane's own:
#
#   * preemption - the device is reclaimed at a round boundary: the armed
#     round never runs, the alert fires, and the decoder drains (live
#     slots checkpoint into the prefix cache, so evacuated requests
#     resume elsewhere with their progress);
#   * pool-growth refusal - device memory exhaustion: the paged BlockPool
#     may not grow for a window of rounds; the refusal surfaces as a
#     caught fault, an alert and a drain, never a wedged pump;
#   * hung scan - a round stops returning in budget: a watchdog compares
#     each pump round's wall time with a threshold.
#
# Every fault ends in the same escalation, the on_alert callbacks then
# ContinuousDecoder.drain, and each logs one warning on the
# "serving.chaos.<name>" logger (a FlightLogHandler puts it in the flight
# recorder's rings).  Faults arm at explicit round numbers and the clock
# is injectable, so a run is deterministic.

from __future__ import annotations

import logging
import time

from .observe.metrics import MirroredStats, default_registry

__all__ = ["ChaosPoolRefusal", "ChaosDecoder"]


class ChaosPoolRefusal(RuntimeError):
    """Injected HBM-exhaustion fault: the pool refused to grow."""


class ChaosDecoder:
    """Fault-injection wrapper around a ContinuousDecoder's pump.

    Register `chaos.pump` with the engine wherever `decoder.pump`
    would go (flatout handler / timer).  Unarmed, it is a transparent
    pass-through — the decoder's behavior is bit-identical.  Armed
    faults fire at deterministic round numbers, count themselves,
    invoke every `on_alert(kind, detail)` callback, and arm the
    decoder's graceful drain with the configured deadline."""

    def __init__(self, decoder, name: str = "chaos", clock=None,
                 drain_deadline: float = 0.0, registry=None):
        self.decoder = decoder
        self.name = str(name)
        self.logger = logging.getLogger(f"serving.chaos.{name}")
        # injectable wall clock (tests substitute a fake so the hung-
        # scan threshold is deterministic); the ENGINE clock is wrong
        # here — a hung scan hangs wall time, not virtual time
        self._clock = clock or time.perf_counter
        # deadline handed to decoder.drain on escalation: 0.0 means
        # "checkpoint at the next round boundary" (preemption grace
        # windows are short; anything in flight checkpoints NOW)
        self.drain_deadline = float(drain_deadline)
        self.on_alert: list = []          # callbacks (kind, detail)
        # evacuation route for the drained requests: descriptors land
        # here, and in on_evacuate's hands when set (a migrator, a
        # re-router) — otherwise each request's own callback delivers
        # the partial generation (degraded, never silently dropped)
        self.on_evacuate = None
        self.evacuated: list = []
        # the lists drain returned, routed as they fill: on a mesh (one
        # rank included) the queue evacuates at the round note that
        # agrees the drain, a round after the escalation
        self._drain_lists: list = []
        self.round = 0
        self._preempt_round: int | None = None
        self._refuse_until_round: int | None = None
        self._hung_threshold: float | None = None
        self._wrapped_alloc = None
        self.stats = MirroredStats(
            {"rounds": 0, "preemptions": 0, "alloc_refusals": 0,
             "hung_scans": 0, "alerts": 0, "drains": 0},
            metric="chaos_decoder_events_total",
            help="injected serving-plane faults by kind",
            registry=registry or default_registry(),
            labels={"chaos": self.name})

    # -- arming ------------------------------------------------------------
    def arm_preemption(self, at_round: int) -> None:
        """Preempt the device at pump round `at_round` (1-based): the
        round does not run, the alert fires, the decoder drains."""
        self._preempt_round = int(at_round)

    def arm_alloc_refusal(self, rounds: int) -> None:
        """Refuse pool GROWTH for the next `rounds` pump rounds: an
        alloc the free list can satisfy proceeds, one that would grow
        the device arrays raises ChaosPoolRefusal — caught by pump(),
        alerted, escalated to drain.  Paged decoders only."""
        pool = getattr(self.decoder, "pool", None)
        if pool is None:
            raise ValueError("alloc refusal needs a paged decoder "
                             "(dense caches have no block pool)")
        self._refuse_until_round = self.round + max(1, int(rounds))
        if self._wrapped_alloc is None:
            self._wrapped_alloc = pool.alloc_blocks

            def refusing_alloc(count, tenant=""):
                count = int(count)
                if self._refusing() and count > len(pool._free):
                    self.stats["alloc_refusals"] += 1
                    raise ChaosPoolRefusal(
                        f"chaos {self.name}: pool growth refused "
                        f"({count} blocks wanted, "
                        f"{len(pool._free)} free)")
                return self._wrapped_alloc(count, tenant=tenant)

            pool.alloc_blocks = refusing_alloc

    def arm_hung_scan(self, threshold_s: float) -> None:
        """Escalate when one pump round's wall time exceeds
        `threshold_s` — the compiled step stopped returning in
        budget."""
        self._hung_threshold = float(threshold_s)

    def disarm(self) -> None:
        """Drop every armed fault and restore the wrapped pool."""
        self._preempt_round = None
        self._hung_threshold = None
        self._refuse_until_round = None
        self._restore_alloc()

    def _refusing(self) -> bool:
        return self._refuse_until_round is not None and \
            self.round <= self._refuse_until_round

    def _restore_alloc(self) -> None:
        if self._wrapped_alloc is not None:
            self.decoder.pool.alloc_blocks = self._wrapped_alloc
            self._wrapped_alloc = None

    # -- escalation --------------------------------------------------------
    def _alert(self, kind: str, detail: dict) -> None:
        self.stats["alerts"] += 1
        self.logger.warning("chaos %s: %s fault at round %d: %r",
                            self.name, kind, self.round, detail)
        for callback in list(self.on_alert):
            try:
                callback(kind, detail)
            except Exception:
                self.logger.exception(
                    "chaos %s: on_alert callback raised", self.name)

    def _evacuated(self, descriptor: dict) -> None:
        self.evacuated.append(descriptor)
        route = self.on_evacuate
        if route is not None:
            try:
                route(descriptor)
            except Exception:
                self.logger.exception(
                    "chaos %s: on_evacuate route failed for %s",
                    self.name, descriptor["request_id"])
            return
        try:
            descriptor["callback"](descriptor["request_id"],
                                   descriptor["generated"])
        except Exception:
            self.logger.exception(
                "chaos %s: degraded delivery failed for %s",
                self.name, descriptor["request_id"])

    def _escalate(self, kind: str, detail: dict) -> None:
        self._alert(kind, detail)
        if not self.decoder.draining:
            self.stats["drains"] += 1
        # queued (never-admitted) requests come back as the drain's
        # return value — route them like the checkpointed ones; a
        # dropped descriptor would be a lost request
        self._drain_lists.append(self.decoder.drain(
            deadline=self.drain_deadline, on_evacuate=self._evacuated))
        self._route_drained()

    def _route_drained(self) -> None:
        """Route what the drains' lists hold now; a list is let go once
        the decoder holds no drain call still to apply."""
        for listed in self._drain_lists:
            while listed:
                self._evacuated(listed.pop(0))
        if not self.decoder.calls_pending:
            self._drain_lists = []

    # -- the wrapped pump --------------------------------------------------
    def pump(self) -> None:
        self.round += 1
        self.stats["rounds"] += 1
        if self._preempt_round is not None and \
                self.round >= self._preempt_round:
            # the device is gone for this round; the grace window is
            # exactly long enough to checkpoint at the next boundary
            self._preempt_round = None
            self.stats["preemptions"] += 1
            self._escalate("preemption", {"round": self.round})
            return
        started = self._clock()
        try:
            self.decoder.pump()
        except ChaosPoolRefusal as exc:
            self._escalate("pool_refusal",
                           {"round": self.round, "error": str(exc)})
            return
        finally:
            if self._refuse_until_round is not None and \
                    self.round >= self._refuse_until_round:
                self._refuse_until_round = None
                self._restore_alloc()
            self._route_drained()
        elapsed = self._clock() - started
        if self._hung_threshold is not None and \
                elapsed > self._hung_threshold:
            self.stats["hung_scans"] += 1
            self._escalate("hung_scan", {"round": self.round,
                                         "elapsed_s": elapsed})
