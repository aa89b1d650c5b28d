"""The port's admission control (ops/admission.py) and the batch
scheduler's wait estimate (ops/batching.py) held against the JAX
package's, call for call: the same seeded scripts of offers, drains,
sheds and releases give the same dispatches, verdicts and per-tenant
counters, the same seeded submits give the same wait estimates, and a
serving pipeline behind a gate sheds a doomed request early alike."""

import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.observe import metrics as JMetrics
from aiko_services_tpu.observe import tracing as JTracing
from aiko_services_tpu.ops import admission as JA
from aiko_services_tpu.ops import batching as JB
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu.transport import wire as JW
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.observe import journey as TJourney
from aiko_services_tpu_torch.observe import metrics as TMetrics
from aiko_services_tpu_torch.observe import tracing as TTracing
from aiko_services_tpu_torch.ops import admission as TA
from aiko_services_tpu_torch.ops import batching as TB
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM
from aiko_services_tpu_torch.transport import wire as TW

PACKAGES = {
    "jax": dict(admission=JA, batching=JB, metrics=JMetrics, event=JE,
                memory=JM, runtime=JProcessRuntime, pipeline=JP,
                tracing=JTracing, wire=JW),
    "torch": dict(admission=TA, batching=TB, metrics=TMetrics, event=TE,
                  memory=TM, runtime=TProcessRuntime, pipeline=TP,
                  tracing=TTracing, wire=TW),
}


def families(registry, *names):
    """Every series of the named families: {(name, labels): value}."""
    out = {}
    for name in names:
        for labels, metric in registry.series(name):
            value = metric.count if hasattr(metric, "count") \
                else metric.value
            out[(name, tuple(sorted(labels.items())))] = value
    return out


# -- the batch scheduler's wait estimate -------------------------------------

def _estimate_script(package, seed):
    batching = PACKAGES[package]["batching"]
    rng = np.random.default_rng(seed)
    now = [0.0]
    scheduler = batching.BatchingScheduler(
        lambda bucket, items: [None] * len(items),
        batching.ShapeBuckets([8, 16, 32]), max_batch=4, max_wait=0.1,
        clock=lambda: now[0])
    readings = [("cold", scheduler.estimated_wait(),
                 scheduler.estimated_wait(8), scheduler.next_deadline(),
                 scheduler.pending())]
    for step in range(80):
        now[0] += float(rng.uniform(0.0, 0.04))
        for _ in range(int(rng.integers(0, 4))):
            deadline = None if rng.random() < 0.5 else \
                now[0] + float(rng.uniform(0.01, 0.3))
            scheduler.submit(f"s{step}", None, int(rng.integers(1, 33)),
                             lambda *_: None, deadline=deadline)
        if rng.random() < 0.3:
            scheduler.observe_service_time(
                int(rng.choice([8, 16, 32])), float(rng.uniform(0.01, 0.1)))
        readings.append((
            step, scheduler.estimated_wait(),
            [scheduler.estimated_wait(b, extra=int(rng.integers(1, 6)))
             for b in (8, 16, 32)],
            [scheduler.service_estimate(b) for b in (8, 16, 32)],
            scheduler.next_deadline(), scheduler.pending()))
        if rng.random() < 0.6:
            scheduler.drain()
        readings.append(("drained", scheduler.pending(),
                         list(scheduler.recent_waits)))
    scheduler.drain(force=True)
    return readings


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wait_estimates_alike_over_seeded_submits(seed):
    port = _estimate_script("torch", seed)
    assert port == _estimate_script("jax", seed)
    assert port[0][1:] == (None, None, None, 0)      # cold: no signal
    estimates = [r[1] for r in port if r[0] not in ("cold", "drained")]
    assert any(e is not None and e > 0 for e in estimates)
    assert any(r[4] is not None for r in port
               if r[0] not in ("cold", "drained"))


# -- the fair queue and the gate ---------------------------------------------

def _queue_script(package, seed):
    admission = PACKAGES[package]["admission"]
    registry = PACKAGES[package]["metrics"].MetricsRegistry()
    rng = np.random.default_rng(seed)
    now = [0.0]
    queue = admission.TenantFairQueue(
        policies={"gold": admission.TenantPolicy(weight=2.0, tier=0),
                  "bulk": admission.TenantPolicy(weight=1.0, tier=1,
                                                 queue_budget=3)},
        base_budget=4, global_budget=9, registry=registry,
        metrics_labels={"pipeline": "q"}, clock=lambda: now[0])
    log = []
    for step in range(120):
        now[0] += float(rng.uniform(0.0, 0.05))
        action = rng.random()
        if action < 0.6:
            tenant = str(rng.choice(["gold", "bulk", "free", ""]))
            item = f"{tenant or 'none'}{step}"
            queued = queue.submit(
                tenant, item, shed=lambda i: log.append(("shed", i)),
                tier=int(rng.integers(0, 3)),
                cost=float(rng.choice([1.0, 1.0, 2.0])))
            log.append(("submit", item, queued, queue.depth(),
                        queue.depth(tenant or "default")))
        elif action < 0.9:
            limit = None if rng.random() < 0.3 else int(rng.integers(1, 4))
            dispatched = []
            count = queue.drain(lambda i: dispatched.append(
                (i, queue.last_dispatch_wait)), limit=limit)
            log.append(("drain", limit, count, dispatched))
        else:
            log.append(("depth", queue.depth()))
    log.append(("shed_all", queue.shed_all(reason="shutdown")))
    return log, families(registry, "admission_admitted_total",
                         "admission_shed_total", "admission_queue_depth",
                         "admission_queue_wait_seconds")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_fair_queue_call_for_call(seed):
    port = _queue_script("torch", seed)
    assert port == _queue_script("jax", seed)
    log, counters = port
    assert any(entry[0] == "shed" for entry in log)
    assert any(name == "admission_admitted_total" for name, _ in counters)


def _gate_script(package):
    admission = PACKAGES[package]["admission"]
    registry = PACKAGES[package]["metrics"].MetricsRegistry()
    gate = admission.AdmissionGate(margin=0.05, inflight_limit=2,
                                   registry=registry,
                                   metrics_labels={"pipeline": "g"})
    log = [("no signal", gate.estimated_wait(), gate.shed_early(0.1))]
    registry.gauge("batch_mean_wait_ms", labels={"program": "p"}).set(250)
    log.append(("gauge", gate.estimated_wait(), gate.shed_early(0.2),
                gate.shed_early(0.5), gate.shed_early(None)))
    waits = iter([0.4, None, 0.1])
    gate.add_wait_estimator(lambda: next(waits))
    gate.add_wait_estimator(lambda: 1 / 0)            # a broken one
    log.append(("estimators", gate.estimated_wait(), gate.estimated_wait(),
                gate.shed_early(0.16)))
    ran = []
    for index in range(5):
        log.append(("offer", gate.offer(
            "acme" if index % 2 else "beta", f"f{index}",
            shed=lambda i: ran.append(("shed", i)), tier=1,
            dispatch=ran.append), gate.inflight, gate.queue.depth()))
    gate.release()
    log.append(("drain", gate.drain(ran.append), gate.inflight))
    gate.release(2)
    log.append(("drain", gate.drain(ran.append), gate.inflight))
    gate.count_rejected("acme", 1, "expired")
    gate.count_rejected("", 0, "shed-early")
    log.append(("ran", ran))
    return log, families(registry, "admission_admitted_total",
                         "admission_rejected_total")


def test_admission_gate_call_for_call():
    port = _gate_script("torch")
    assert port == _gate_script("jax")
    log, counters = port
    assert log[0][1:] == (None, (False, None))
    assert log[1][1] == pytest.approx(0.25)


def test_deadline_router_call_for_call():
    def script(package):
        routes = []
        router = PACKAGES[package]["admission"].DeadlineRouter(
            urgent_budget_s=0.5, name="r",
            registry=PACKAGES[package]["metrics"].MetricsRegistry(),
            on_route=lambda choice, remaining: routes.append(
                (choice, remaining)))
        loads = {"b": 3, "a": 1, "c": 1}
        picks = [router.route(loads, remaining)
                 for remaining in (None, 2.0, 0.2, 0.5, 3.0, 0.1)]
        picks.append(router.route({}, 0.1))
        return picks, routes
    port = script("torch")
    assert port == script("jax")
    assert port[0][2] == "a" and port[0][-1] is None


@pytest.mark.parametrize("call", [
    lambda gate: gate.watch_decoder(object()),
    lambda gate: gate.set_byte_policy(object(), budget_bytes=1),
    lambda gate: gate.shed_on_bytes("acme")])
def test_decoder_and_ledger_verdicts_raise_naming_their_item(call):
    gate = TA.AdmissionGate(registry=TMetrics.MetricsRegistry())
    with pytest.raises(NotImplementedError, match="Queue 1 item 5\\)"):
        call(gate)


# -- a serving pipeline behind a gate ----------------------------------------

def _shed_early_script(package):
    """adapted from tests/test_admission.py: a doomed request is shed
    before any walk, its retry replays the verdict, a healthy request
    walks through the fair queue."""
    m = PACKAGES[package]
    engine = m["event"].EventEngine(m["event"].VirtualClock())
    broker = m["memory"].MemoryBroker()
    runtime = m["runtime"](
        name="shed_rt", engine=engine, namespace="test",
        process_id="shed_rt",
        transport_factory=lambda on_message, *_: m["memory"].MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    P = m["pipeline"]

    class PE_Echo(P.PipelineElement):
        def process_frame(self, frame, value=None, **_):
            return P.FrameOutput(True, {"echo": value})

    gate = m["admission"].AdmissionGate(
        metrics_labels={"pipeline": f"shed_{package}"})
    estimate = [10.0]
    gate.add_wait_estimator(lambda: estimate[0])
    serving = P.Pipeline(runtime, P.parse_pipeline_definition({
        "version": 0, "name": "shed_serve", "runtime": "python",
        "graph": ["(PE_Echo)"],
        "elements": [{"name": "PE_Echo", "input": [{"name": "value"}],
                      "output": [{"name": "echo"}]}]}),
        element_classes={"PE_Echo": PE_Echo},
        auto_create_streams=True, stream_lease_time=0, admission=gate)
    replies, served = [], []
    serving.add_frame_handler(lambda frame: served.append(frame.stream_id))
    runtime.add_message_handler(
        lambda _t, payload: replies.append(
            m["wire"].decode_envelope(payload)
            if isinstance(payload, bytes) else payload), "reply/t")

    def settle():
        for _ in range(30):
            while engine.step():
                pass
            engine.clock.advance(0.01)

    tracing = m["tracing"]
    doomed = tracing.TraceContext("t1", "s1",
                                  deadline=engine.clock.now() + 1.0)
    serving.process_frame_remote(
        "s1", {"value": 1}, "reply/t", "h1",
        doomed.to_fields(engine.clock.now()),
        m["wire"].tenant_fields("acme", 1))
    settle()
    serving.process_frame_remote(               # the retry
        "s1", {"value": 1}, "reply/t", "h1",
        doomed.to_fields(engine.clock.now()))
    settle()
    estimate[0] = 0.01
    healthy = tracing.TraceContext("t2", "s2",
                                   deadline=engine.clock.now() + 5.0)
    serving.process_frame_remote(
        "s2", {"value": 2}, "reply/t", "h2",
        healthy.to_fields(engine.clock.now()),
        m["wire"].tenant_fields("acme", 1))
    settle()
    expired = tracing.TraceContext("t3", "s3",
                                   deadline=engine.clock.now() - 1.0)
    serving.process_frame_remote(
        "s3", {"value": 3}, "reply/t", "h3",
        expired.to_fields(engine.clock.now()))
    settle()
    serving.stop()
    runtime.terminate()
    return (dict(serving.recovery_stats), served, replies,
            gate.inflight, gate.queue.depth(),
            len(engine.live_timer_handlers()))


def test_serving_pipeline_sheds_early_under_a_deadline():
    port = _shed_early_script("torch")
    assert port == _shed_early_script("jax")
    stats, served, replies, inflight, depth, timers = port
    assert stats["shed_early"] == 1 and stats["dup_requests"] == 1
    assert stats["replayed_replies"] == 1
    assert stats["deadline_rejected"] == 1
    assert served == ["s2"]
    assert "shed-early" in str(replies[0]) and len(replies) == 4
    assert (inflight, depth, timers) == (0, 0, 0)
    # the admitted walk left its verdict for a decoder's journey
    note = TJourney.take_admission_note("t2")
    assert note["verdict"] == "admitted" and note["tenant"] == "acme"
    assert note["queue_wait_s"] == 0.0
