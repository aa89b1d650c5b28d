# Request journeys: per-request lifecycle records for the serving path.
#
# The port's own copy of aiko_services_tpu/observe/journey.py.  A
# RequestJourney is one ContinuousDecoder request's record: the pipeline
# admission verdict and measured fair-queue wait (delivered through the
# bounded note_admission / take_admission_note handoff keyed by trace id),
# the decoder queue time (submit -> slot), the prefill admit / extend
# waves it rode, a bounded ring of per-token emission stamps, and the
# deadline margin and outcome at completion (deadline-met /
# deadline-missed / no-deadline / shed / drained / evacuated).  The
# decoder captures the ambient TraceContext at submit, so one trace id
# spans wire hop -> admission -> decoder slot -> token stream; on
# completion the JourneyLog emits the journey as child spans of that
# context (journey:request > journey:admission / journey:queue /
# journey:prefill / journey:token) into the process Tracer, whose taps
# route them into the flight recorder's rings.  Field names, outcomes,
# span names and the journey_requests_total{log, tenant, outcome,
# prefill} family are the JAX package's.
#
# Clock domains: journey stamps are the decoder's scheduler clock
# (time.monotonic), the admission note's queue wait the engine clock;
# they are carried as separate fields, never subtracted across domains.

from __future__ import annotations

from collections import OrderedDict, deque

from .metrics import MetricsRegistry, default_registry
from .tracing import TraceContext, new_span_id, \
    tracer as _global_tracer

__all__ = ["RequestJourney", "JourneyLog", "note_admission",
           "take_admission_note", "pending_admission_notes",
           "tenant_slo_rows", "DEFAULT_TOKEN_RING"]

DEFAULT_TOKEN_RING = 64       # per-request token timestamps retained
_NOTE_CAP = 512               # pending admission notes (bounded)

# trace_id -> {"verdict", "queue_wait_s", "tenant", "tier"}; insertion
# ordered so the bound sheds OLDEST — a note whose request died before
# reaching a decoder ages out instead of leaking
_pending_notes: OrderedDict[str, dict] = OrderedDict()


def note_admission(trace_id: str, verdict: str,
                   queue_wait_s: float | None = None,
                   tenant: str = "", tier: int = 1) -> None:
    """Record one admission verdict for the journey that MAY follow
    (pipeline.process_frame_remote calls this just before the serving
    walk runs; the decoder's submit — synchronous inside that walk —
    collects it).  Bounded at _NOTE_CAP, oldest shed."""
    if not trace_id:
        return
    _pending_notes[str(trace_id)] = {
        "verdict": str(verdict),
        "queue_wait_s": queue_wait_s,
        "tenant": str(tenant or ""),
        "tier": int(tier),
    }
    _pending_notes.move_to_end(str(trace_id))
    while len(_pending_notes) > _NOTE_CAP:
        _pending_notes.popitem(last=False)


def take_admission_note(trace_id: str) -> dict | None:
    """Claim (and remove) the pending admission note for a trace id."""
    if not trace_id:
        return None
    return _pending_notes.pop(str(trace_id), None)


def pending_admission_notes() -> int:
    return len(_pending_notes)


class RequestJourney:
    """One request's lifecycle through the serving path (module doc)."""

    __slots__ = ("request_id", "trace_id", "parent_span_id", "span_id",
                 "tenant", "tier", "submit_t", "admitted_t",
                 "first_token_t", "done_t", "admission_verdict",
                 "admission_wait_s", "slot", "waves", "token_ticks",
                 "tokens_total", "deadline", "deadline_margin_s",
                 "outcome", "prompt_tokens", "prefix_hit_tokens",
                 "prefill_label")

    def __init__(self, request_id: str, submit_t: float,
                 trace_id: str = "", parent_span_id: str = "",
                 tenant: str = "", tier: int = 1,
                 deadline: float | None = None,
                 admission_verdict: str = "",
                 admission_wait_s: float | None = None,
                 prompt_tokens: int = 0,
                 token_ring: int = DEFAULT_TOKEN_RING):
        self.request_id = str(request_id)
        self.trace_id = str(trace_id)
        self.parent_span_id = str(parent_span_id)
        self.span_id = new_span_id()      # the journey:request span
        self.tenant = str(tenant or "")
        self.tier = int(tier)
        self.submit_t = float(submit_t)
        self.admitted_t: float | None = None
        self.first_token_t: float | None = None
        self.done_t: float | None = None
        self.admission_verdict = str(admission_verdict)
        self.admission_wait_s = admission_wait_s
        self.slot = -1
        self.waves: dict[str, int] = {}     # admit/chunk-admit/extend
        self.token_ticks: deque = deque(maxlen=int(token_ring))
        self.tokens_total = 0
        self.deadline = deadline
        self.deadline_margin_s: float | None = None
        self.outcome = ""
        self.prompt_tokens = int(prompt_tokens)
        # prompt tokens satisfied from the prefix/KV reuse cache at
        # admit: 0 = cold prefill, >0 = cached — the
        # decoder stamps it at slot assignment, and the journey's
        # spans/outcome counters carry the cached-vs-cold tag
        self.prefix_hit_tokens = 0
        # explicit population override: "" derives
        # cached/cold from prefix_hit_tokens; the disaggregated
        # serving client stamps "remote" so journeys whose prompt KV
        # was computed by a prefill runtime form their own population
        self.prefill_label = ""

    def prefill(self) -> str:
        """The journey's prefill population: the explicit label when
        set (e.g. "remote"), else cached/cold from the prefix hit."""
        return self.prefill_label or \
            ("cached" if self.prefix_hit_tokens else "cold")

    # -- lifecycle hooks (decoder clock) -------------------------------------
    def admitted(self, t: float, slot: int, kind: str = "admit") -> None:
        if self.admitted_t is None:
            self.admitted_t = float(t)
            self.slot = int(slot)
        self.wave(kind)

    def wave(self, kind: str) -> None:
        self.waves[kind] = self.waves.get(kind, 0) + 1

    def token(self, t: float) -> None:
        if self.first_token_t is None:
            self.first_token_t = float(t)
        self.token_ticks.append(float(t))
        self.tokens_total += 1

    def finish(self, t: float, outcome: str = "") -> None:
        self.done_t = float(t)
        if self.deadline is not None:
            self.deadline_margin_s = float(self.deadline) - self.done_t
        if outcome:
            self.outcome = outcome
        elif self.deadline is not None:
            self.outcome = "deadline-met" \
                if self.deadline_margin_s >= 0 else "deadline-missed"
        else:
            self.outcome = "no-deadline"

    # -- reads ---------------------------------------------------------------
    def ttft_s(self) -> float | None:
        return None if self.first_token_t is None \
            else self.first_token_t - self.submit_t

    def queue_wait_s(self) -> float | None:
        """Decoder-side queue wait (submit → slot assigned)."""
        return None if self.admitted_t is None \
            else self.admitted_t - self.submit_t

    def itl_s(self) -> float | None:
        """Mean inter-token latency over the RETAINED tick ring."""
        ticks = self.token_ticks
        if len(ticks) < 2:
            return None
        return (ticks[-1] - ticks[0]) / (len(ticks) - 1)

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "tenant": self.tenant, "tier": self.tier,
            "admission_verdict": self.admission_verdict,
            "admission_wait_s": self.admission_wait_s,
            "submit_t": self.submit_t,
            "admitted_t": self.admitted_t,
            "first_token_t": self.first_token_t,
            "done_t": self.done_t,
            "slot": self.slot, "waves": dict(self.waves),
            "token_ticks": list(self.token_ticks),
            "tokens_total": self.tokens_total,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill": self.prefill(),
            "ttft_s": self.ttft_s(),
            "queue_wait_s": self.queue_wait_s(),
            "itl_s": self.itl_s(),
            "deadline_margin_s": self.deadline_margin_s,
            "outcome": self.outcome,
        }

    # -- span emission -------------------------------------------------------
    def emit_spans(self, trace_source=None, proc: str = "") -> int:
        """Record the journey as child spans of its trace context:
        journey:request (the whole lifetime, parented to the frame's
        hop span) > journey:admission / journey:queue / journey:prefill
        / one journey:token per retained tick.  No-op (returns 0) when
        the tracer is disabled — per-token spans are evidence, not a
        tax the hot path always pays."""
        source = trace_source or _global_tracer
        if not source.enabled or self.done_t is None:
            return 0
        emitted = 0

        def record(name, ts, dur, args, span_id=None, parent=None):
            nonlocal emitted
            context = TraceContext(
                self.trace_id, span_id or new_span_id(),
                parent_id=self.span_id if parent is None else parent)
            source.record(name, ts, max(0.0, dur), context=context,
                          cat="journey", proc=proc, args=args)
            emitted += 1

        record("journey:request", self.submit_t,
               self.done_t - self.submit_t,
               {"request_id": self.request_id, "tenant": self.tenant,
                "outcome": self.outcome, "slot": self.slot,
                "tokens": self.tokens_total,
                "prefill": self.prefill(),
                "deadline_margin_s": self.deadline_margin_s},
               span_id=self.span_id, parent=self.parent_span_id)
        record("journey:admission", self.submit_t,
               self.admission_wait_s or 0.0,
               {"verdict": self.admission_verdict or "direct",
                "queue_wait_s": self.admission_wait_s,
                "tenant": self.tenant, "tier": self.tier})
        if self.admitted_t is not None:
            record("journey:queue", self.submit_t,
                   self.admitted_t - self.submit_t,
                   {"slot": self.slot})
            first = self.first_token_t or self.done_t
            record("journey:prefill", self.admitted_t,
                   first - self.admitted_t,
                   {"waves": dict(self.waves),
                    "prompt_tokens": self.prompt_tokens,
                    "prefix_hit_tokens": self.prefix_hit_tokens})
        for index, tick in enumerate(self.token_ticks):
            record("journey:token", tick, 0.0, {"index": index})
        return emitted


class JourneyLog:
    """Bounded ring of completed journeys for one decoder (or one
    process): finish() completes the journey, emits its spans, and
    mirrors the outcome into `journey_requests_total{tenant, outcome}`
    — the counter family the per-tenant SLO report reads deadline
    attainment from."""

    def __init__(self, name: str = "journeys", maxlen: int = 256,
                 proc: str = "",
                 registry: MetricsRegistry | None = None):
        self.name = name
        self.proc = proc or name
        self.completed: deque = deque(maxlen=int(maxlen))
        self._registry = registry or default_registry()
        self._counters: dict = {}

    def _count(self, tenant: str, outcome: str,
               prefill: str = "cold") -> None:
        key = (tenant, outcome, prefill)
        counter = self._counters.get(key)
        if counter is None:
            counter = self._registry.counter(
                "journey_requests_total",
                "completed request journeys by tenant, outcome, and "
                "cached/cold prefill",
                labels={"log": self.name,
                        "tenant": tenant or "default",
                        "outcome": outcome,
                        "prefill": prefill})
            self._counters[key] = counter
        counter.inc()

    def finish(self, journey: RequestJourney, t: float,
               outcome: str = "") -> None:
        journey.finish(t, outcome)
        self.completed.append(journey)
        self._count(journey.tenant, journey.outcome, journey.prefill())
        journey.emit_spans(proc=self.proc)

    def journey_for(self, trace_id: str) -> RequestJourney | None:
        """Newest completed journey under a trace id (the alert
        exemplar lookup; the ring is small, a scan is fine)."""
        for journey in reversed(self.completed):
            if journey.trace_id == trace_id:
                return journey
        return None

    def journeys(self, count: int | None = None) -> list:
        entries = list(self.completed)
        return entries[-count:] if count else entries


# -- per-tenant SLO aggregation ----------------------------------------------

def tenant_slo_rows(snapshots, objective: float | None = None) -> list:
    """Per-tenant SLO attainment rows from retained metrics snapshot
    documents' `snapshot` bodies (one or many — pass several to merge a
    fleet).  Shared by the Dashboard metrics pane and
    scripts/slo_report.py so both read the SAME numbers:

      [{"tenant", "completed", "deadline_met", "deadline_missed",
        "attainment" (None without deadlines), "ttft_p50_ms"...,
        "itl_p95_ms"..., "shed", "rejected", "device_bytes",
        "host_bytes", "byte_seconds", "demotions", "promotions",
        "exemplars", "met"}, ...]

    The memory columns read the KV ledger families (kv_ledger_bytes
    by tier, kv_ledger_byte_seconds, kv_ledger_moves_total by dir) —
    zero when no ledger is attached.

    TTFT sketches carrying the serving prefill label are
    ADDITIONALLY merged per population into ttft_{cached,cold}_p50_ms /
    _p95_ms rows, so the report quotes what the prefix cache actually
    bought each tenant (the blended percentile hides a cache that only
    helps the warm half).

    `met` is the per-tenant verdict against `objective` (None =
    reporting only, every tenant passes)."""
    from .sketch import Sketch, merge_sketches

    outcomes: dict[str, dict] = {}
    sketches: dict[tuple, list] = {}      # (tenant, family) -> [Sketch]
    split_ttft: dict[tuple, list] = {}    # (tenant, prefill) -> [Sketch]
    shed: dict[str, float] = {}
    rejected: dict[str, float] = {}
    mem_bytes: dict[tuple, float] = {}    # (tenant, tier) -> bytes
    byte_seconds: dict[str, float] = {}
    moves: dict[tuple, float] = {}        # (tenant, dir) -> count

    def tenant_of(labels: dict) -> str:
        return str(labels.get("tenant") or "default")

    for snapshot in snapshots:
        for family, entry in (snapshot or {}).items():
            kind = entry.get("type", "")
            for series in entry.get("series", []):
                labels = series.get("labels", {}) or {}
                if family == "journey_requests_total":
                    tenant = tenant_of(labels)
                    outcome = str(labels.get("outcome", ""))
                    row = outcomes.setdefault(tenant, {})
                    row[outcome] = row.get(outcome, 0) + \
                        float(series.get("value", 0))
                elif kind == "sketch" and family in (
                        "serving_ttft_seconds", "serving_itl_seconds"):
                    sketch = Sketch.from_dict(series)
                    if sketch is not None:
                        key = (tenant_of(labels), family)
                        sketches.setdefault(key, []).append(sketch)
                        prefill = str(labels.get("prefill") or "")
                        if prefill and family == "serving_ttft_seconds":
                            split_ttft.setdefault(
                                (tenant_of(labels), prefill),
                                []).append(sketch)
                elif family == "admission_shed_total":
                    tenant = tenant_of(labels)
                    shed[tenant] = shed.get(tenant, 0) + \
                        float(series.get("value", 0))
                elif family == "admission_rejected_total":
                    tenant = tenant_of(labels)
                    rejected[tenant] = rejected.get(tenant, 0) + \
                        float(series.get("value", 0))
                elif family == "kv_ledger_bytes":
                    key = (tenant_of(labels),
                           str(labels.get("tier") or ""))
                    mem_bytes[key] = mem_bytes.get(key, 0) + \
                        float(series.get("value", 0))
                elif family == "kv_ledger_byte_seconds":
                    tenant = tenant_of(labels)
                    byte_seconds[tenant] = \
                        byte_seconds.get(tenant, 0) + \
                        float(series.get("value", 0))
                elif family == "kv_ledger_moves_total":
                    key = (tenant_of(labels),
                           str(labels.get("dir") or ""))
                    moves[key] = moves.get(key, 0) + \
                        float(series.get("value", 0))

    tenants = sorted(set(outcomes) | {t for t, _ in sketches}
                     | set(shed) | set(rejected)
                     | {t for t, _ in mem_bytes})
    rows = []
    for tenant in tenants:
        counts = outcomes.get(tenant, {})
        met = counts.get("deadline-met", 0)
        missed = counts.get("deadline-missed", 0)
        attainment = met / (met + missed) if (met + missed) else None
        row = {
            "tenant": tenant,
            "completed": int(sum(counts.values())),
            "deadline_met": int(met),
            "deadline_missed": int(missed),
            "attainment": attainment,
            "shed": int(shed.get(tenant, 0)),
            "rejected": int(rejected.get(tenant, 0)),
            # KV memory ledger attribution: live bytes per
            # tier, integrated footprint, and tier-move counts
            "device_bytes": int(mem_bytes.get((tenant, "device"), 0)),
            "host_bytes": int(mem_bytes.get((tenant, "host"), 0)),
            "byte_seconds": float(byte_seconds.get(tenant, 0.0)),
            "demotions": int(moves.get((tenant, "demote"), 0)),
            "promotions": int(moves.get((tenant, "promote"), 0)),
            "exemplars": [],
        }
        for family, prefix in (("serving_ttft_seconds", "ttft"),
                               ("serving_itl_seconds", "itl")):
            merged = merge_sketches(sketches.get((tenant, family), []))
            for q, suffix in ((0.5, "p50"), (0.95, "p95"),
                              (0.99, "p99")):
                value = merged.quantile(q) if merged is not None \
                    else None
                row[f"{prefix}_{suffix}_ms"] = \
                    None if value is None else value * 1000.0
            if merged is not None and prefix == "ttft":
                # dedup by trace id: ONE frame's trace fans out to a
                # request per decoder, so merged sketches legitimately
                # repeat a trace — the report wants distinct requests
                seen: set = set()
                row["exemplars"] = [
                    e[1] for e in merged.worst_exemplars(8)
                    if not (e[1] in seen or seen.add(e[1]))][:4]
        for prefill in ("cached", "cold"):
            merged = merge_sketches(
                split_ttft.get((tenant, prefill), []))
            if merged is not None:
                for q, suffix in ((0.5, "p50"), (0.95, "p95")):
                    value = merged.quantile(q)
                    row[f"ttft_{prefill}_{suffix}_ms"] = \
                        None if value is None else value * 1000.0
        row["met"] = True if objective is None or attainment is None \
            else attainment >= objective
        rows.append(row)
    return rows
