"""The port's request journeys (observe/journey.py) and the decoder's SLO
surfaces against the JAX package's.

A scripted journey (admission note, admits, extend waves, token ticks,
finish with and without a deadline) gives the same record, outcome
counters and child spans in both packages; tenant_slo_rows reads both
registries' snapshots alike.  Then the same traffic drives a JAX and a
port ContinuousDecoder (tiny preset, f32, dense and paged) on a virtual
scheduler clock (each serving module's `time` replaced by a clock the
test advances between rounds): journeys, slo_stats() and
slo_sketch_stats() (by tenant and by cached / cold prefill) must be
equal, with the outcomes deadline-met, deadline-missed, no-deadline,
shed and drained all present."""

import dataclasses
import functools
import json
import time
import types

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu.observe import journey as JJ
from aiko_services_tpu.observe import metrics as JM
from aiko_services_tpu.observe import tracing as JT
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe import journey as TJ
from aiko_services_tpu_torch.observe import metrics as TM
from aiko_services_tpu_torch.observe import tracing as TT

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], max_seq_len=96)
T_CONFIG = TL.LlamaConfig(**{field.name: getattr(J_CONFIG, field.name)
                             for field in dataclasses.fields(J_CONFIG)})
PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
# ids that differ by construction between two runs
VOLATILE = ()


@functools.cache
def weights():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     T_CONFIG, device="cpu")
    return params, model


def scripted(module, registry, tracer, deadline, outcome=""):
    journey = module.RequestJourney(
        "r1", 10.0, trace_id="t1", parent_span_id="p1", tenant="acme",
        tier=2, deadline=deadline, admission_verdict="admitted",
        admission_wait_s=0.25, prompt_tokens=40, token_ring=4)
    journey.admitted(10.5, 3, "chunk-admit")
    journey.wave("extend")
    journey.wave("extend")
    journey.prefix_hit_tokens = 16
    for i in range(6):
        journey.token(11.0 + 0.1 * i)
    log = module.JourneyLog(name="log", proc="proc", registry=registry)
    journey.finish(12.0, outcome)
    log.completed.append(journey)
    log._count(journey.tenant, journey.outcome, journey.prefill())
    emitted = journey.emit_spans(trace_source=tracer, proc="proc")
    return journey, log, emitted


@pytest.mark.parametrize("deadline,outcome", [
    (None, ""), (12.5, ""), (11.5, ""), (None, "evacuated"),
    (12.5, "shed")])
def test_scripted_journey_records_and_spans_match(deadline, outcome):
    jax_tracer, port_tracer = JT.Tracer(enabled=True), \
        TT.Tracer(enabled=True)
    jax_registry, port_registry = JM.MetricsRegistry(), TM.MetricsRegistry()
    expected, _, jax_emitted = scripted(JJ, jax_registry, jax_tracer,
                                        deadline, outcome)
    got, log, emitted = scripted(TJ, port_registry, port_tracer, deadline,
                                 outcome)
    want = expected.to_dict()
    assert got.to_dict() == want
    assert want["outcome"] == (outcome or {None: "no-deadline",
                                           12.5: "deadline-met",
                                           11.5: "deadline-missed"}
                               [deadline])
    assert emitted == jax_emitted == 2 + 2 + 4      # ring of 4 ticks
    spans = [(s.name, s.ts, s.dur, s.cat, s.proc, s.trace_id, s.args)
             for s in port_tracer.spans]
    assert spans == [(s.name, s.ts, s.dur, s.cat, s.proc, s.trace_id,
                      s.args) for s in jax_tracer.spans]
    # the request span is the journey's own id, parented to the hop
    assert port_tracer.spans[0].span_id == got.span_id
    assert port_tracer.spans[0].parent_id == "p1"
    assert json.dumps(port_registry.snapshot(), sort_keys=True) == \
        json.dumps(jax_registry.snapshot(), sort_keys=True)
    assert log.journey_for("t1") is got and log.journeys(1) == [got]


def test_admission_notes_hand_off_once_and_stay_bounded():
    for trace in range(600):
        TJ.note_admission(f"t{trace}", "admitted", 0.1, "acme", 1)
    assert TJ.pending_admission_notes() == 512          # oldest shed
    assert TJ.take_admission_note("t0") is None
    assert TJ.take_admission_note("t599") == {
        "verdict": "admitted", "queue_wait_s": 0.1, "tenant": "acme",
        "tier": 1}
    assert TJ.take_admission_note("t599") is None
    while TJ.pending_admission_notes():
        TJ._pending_notes.popitem()


def test_tenant_slo_rows_read_both_snapshots_alike():
    snapshots = []
    for metrics, module, sketch_module in (
            (JM, JJ, JM), (TM, TJ, TM)):
        registry = metrics.MetricsRegistry()
        log = module.JourneyLog(name="rows", registry=registry)
        rng = np.random.default_rng(5)
        for tenant in ("acme", "beta"):
            for outcome in ("deadline-met", "deadline-met",
                            "deadline-missed", "shed"):
                log._count(tenant, outcome, "cached")
            for prefill in ("cached", "cold"):
                sketch = registry.sketch(
                    "serving_ttft_seconds",
                    labels={"decoder": "d", "tenant": tenant,
                            "prefill": prefill})
                for i, value in enumerate(rng.exponential(0.05, 50)):
                    sketch.observe(float(value), exemplar=f"{tenant}{i}")
        registry.counter("kv_ledger_bytes_dummy").inc()
        registry.gauge("kv_ledger_bytes",
                       labels={"ledger": "l", "tier": "device",
                               "tenant": "acme"}).set(4096)
        registry.counter("kv_ledger_moves_total",
                         labels={"ledger": "l", "tenant": "acme",
                                 "dir": "demote"}).inc(3)
        snapshots.append(registry.snapshot())
    rows = TJ.tenant_slo_rows([snapshots[1]], objective=0.5)
    assert rows == JJ.tenant_slo_rows([snapshots[0]], objective=0.5)
    assert [row["tenant"] for row in rows] == ["acme", "beta"]
    assert rows[0]["attainment"] == pytest.approx(2 / 3)
    assert rows[0]["device_bytes"] == 4096 and rows[0]["demotions"] == 3
    assert rows[0]["ttft_cached_p50_ms"] is not None


# -- the decoders on a virtual scheduler clock ---------------------------

class Clock:
    def __init__(self):
        self.now = 100.0

    def namespace(self):
        return types.SimpleNamespace(monotonic=lambda: self.now,
                                     perf_counter=time.perf_counter)


def traffic(decoder, clock, tracing, notes, paged: bool) -> dict:
    """The scripted traffic: two tenants, deadlines set before the first
    round (no round estimate yet, so nothing sheds on wall time), a
    mid-stream submit, an admission note under an ambient trace, a
    forced shed and a drained refusal.  Returns the completions."""
    done = {}

    def keep(request_id, tokens):
        done[request_id] = [int(t) for t in tokens]

    start = clock.now
    decoder.submit("a", PROMPT, 10, keep, deadline=start + 0.6,
                   tenant="acme")
    decoder.submit("b", PROMPT[:17] + [3, 4], 8, keep,
                   deadline=start + 0.05, tenant="beta")
    context = tracing.TraceContext("trace-c", "span-c")
    notes.note_admission(context.trace_id, "admitted", 0.125, "beta", 2)
    with tracing.activate(context):
        decoder.submit("c", PROMPT[:9] + [7], 6, keep)
    for i in range(200):
        clock.now += 0.05
        if i == 2:
            decoder.submit("d", PROMPT[:24], 7, keep, tenant="acme")
        if i == 3 and paged:
            # the second turn of "a": a prefix hit, the cached population
            decoder.submit("a2", PROMPT + [5, 6, 7, 8, 9, 10, 11, 12, 13],
                           5, keep, tenant="acme")
        decoder.pump()
        if len(done) == (5 if paged else 4):
            break
    # a doomed deadline against a measured round: shed at submit
    decoder._round_ewma = 0.5
    assert not decoder.submit("shed", [9], 4, keep,
                              deadline=clock.now + 0.01, tenant="beta")
    decoder.drain()
    assert not decoder.submit("late", [9], 4, keep, tenant="acme")
    decoder.resume()
    return done


def journeys(decoder) -> list:
    return [{key: value for key, value in journey.to_dict().items()
             if key not in VOLATILE}
            for journey in decoder.journeys.journeys()]


@pytest.mark.parametrize("paged", [False, True])
def test_decoder_journeys_and_slo_surfaces_match(monkeypatch, paged):
    params, model = weights()
    kwargs = {"max_slots": 4, "prefill_buckets": (64,),
              "steps_per_sync": 4}
    if paged:
        kwargs.update(paged_kv=True, kv_block=8)
    clock = Clock()
    monkeypatch.setattr(JS, "time", clock.namespace())
    monkeypatch.setattr(TS, "time", clock.namespace())
    results = []
    for module, config, weights_, tracing, notes, extra in (
            (JS, J_CONFIG, params, JT, JJ,
             {"registry": JM.MetricsRegistry()}),
            (TS, T_CONFIG, model, TT, TJ,
             {"device": "cpu", "registry": TM.MetricsRegistry()})):
        clock.now = 100.0
        cache = module.PrefixKVCache(block_tokens=8, name="jc") \
            if paged else None
        decoder = module.ContinuousDecoder(weights_, config,
                                           prefix_cache=cache,
                                           name="journeys", **kwargs,
                                           **extra)
        done = traffic(decoder, clock, tracing, notes, paged)
        results.append((done, journeys(decoder), decoder.slo_stats(),
                        {(tenant, prefill): decoder.slo_sketch_stats(
                            prefill=prefill, tenant=tenant)
                         for tenant in (None, "acme", "beta")
                         for prefill in (None, "cached", "cold")},
                        decoder))
    (j_done, j_journeys, j_slo, j_sketch, _), \
        (t_done, t_journeys, t_slo, t_sketch, port) = results
    assert t_done == j_done
    assert t_journeys == j_journeys
    assert t_slo == j_slo
    assert t_sketch == j_sketch
    outcomes = sorted(journey["outcome"] for journey in t_journeys)
    assert {"deadline-met", "deadline-missed", "no-deadline", "shed",
            "drained"} <= set(outcomes)
    assert port.stats["admission_shed"] == 1
    assert port.stats["drain_refused"] == 1
    note = next(journey for journey in t_journeys
                if journey["request_id"] == "c")
    assert note["admission_verdict"] == "admitted"
    assert note["tenant"] == "beta" and note["tier"] == 2
    if paged:
        cached = next(journey for journey in t_journeys
                      if journey["request_id"] == "a2")
        assert cached["prefill"] == "cached"
        assert cached["prefix_hit_tokens"] > 0
        assert t_sketch[(None, "cached")]["ttft_p50_ms"] is not None
    assert t_sketch[("acme", None)]["ttft_exemplars"]
    port.clear_slo_sketches()
    assert port.slo_sketch_stats()["ttft_p50_ms"] is None
