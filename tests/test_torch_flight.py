"""The port's flight recorder (observe/flight.py) against the JAX
package's.

Bare recorders fed the same spans, samples, logs and faults merge into
the same Chrome trace-event document; record_fault reaches every
registered recorder and is free without one; the tracer tap routes spans
by proc name; FlightLogHandler fans WARNING records in (one per chaos
decoder fault: serving_chaos.py logs one); sample_now reads a registry
under the JAX series keys; DumpOnAlert writes one dump per rule; the
port's FaultPlan records each injected fault as JAX's does."""

import json
import logging

import pytest

from aiko_services_tpu.observe import flight as JF
from aiko_services_tpu.observe import metrics as JM
from aiko_services_tpu.observe import tracing as JT
from aiko_services_tpu_torch.observe import flight as TF
from aiko_services_tpu_torch.observe import metrics as TM
from aiko_services_tpu_torch.observe import tracing as TT
from aiko_services_tpu_torch.transport import chaos as TC


@pytest.fixture(autouse=True)
def no_recorders():
    for module in (JF, TF):
        for recorder in module.recorders():
            module.unregister(recorder)
    yield
    for module in (JF, TF):
        for recorder in module.recorders():
            module.unregister(recorder)


def feed(flight, tracing, name: str):
    recorder = flight.FlightRecorder(name=name, maxlen=8)
    for i in range(10):                        # the ring keeps the last 8
        recorder.record_span(tracing.SpanRecord(
            name=f"hop{i}", ts=1.0 + i, dur=0.25, trace_id=f"t{i}",
            span_id=f"s{i}", parent_id="p", cat="hop", proc=name,
            args={"i": i}))
        recorder.record_sample(2.0 + i, "queue{pipeline=p}", i * 3)
        recorder.record_log(3.0 + i, "WARNING", "serving", f"log {i}")
        recorder.record_fault(4.0 + i, "drop", "topic/in", "a", "b")
    return recorder


def test_merged_documents_match():
    jax_doc = JF.merge([feed(JF, JT, "alpha"), feed(JF, JT, "beta")])
    port_doc = TF.merge([feed(TF, TT, "alpha"), feed(TF, TT, "beta")])
    assert json.dumps(port_doc, sort_keys=True) == \
        json.dumps(jax_doc, sort_keys=True)
    kinds = sorted({event["ph"] for event in port_doc["traceEvents"]})
    assert kinds == ["C", "M", "X", "i"]
    assert sum(event["name"] == "fault:drop"
               for event in port_doc["traceEvents"]) == 16


def test_record_fault_reaches_every_recorder():
    TF.record_fault("partitioned", "t/in", "a", "b", 1.0)   # no recorder
    first = TF.FlightRecorder(name="first")
    second = TF.FlightRecorder(name="second")
    TF.record_fault("drop", "t/in", "a", "b", 2.0)
    TF.record_fault("duplicate", "t/out", t=3.0)
    assert list(first.faults) == list(second.faults) == [
        (2.0, "drop", "t/in", "a", "b"), (3.0, "duplicate", "t/out", "", "")]
    second.close()
    assert TF.recorders() == [first]


def test_tracer_tap_routes_spans_by_proc():
    tracer = TT.Tracer(enabled=True)
    TF._install_tracer_tap(tracer)
    owner = TF.FlightRecorder(name="owner")
    other = TF.FlightRecorder(name="other")
    tracer.record("a", 1.0, 0.5, proc="other")
    tracer.record("b", 2.0, 0.5, proc="nobody")     # unclaimed: the first
    tracer.record("c", 3.0, 0.5, proc="owner")
    assert [s.name for s in owner.spans] == ["b", "c"]
    assert [s.name for s in other.spans] == ["a"]
    tracer.taps.append(lambda span: 1 / 0)          # a broken tap
    tracer.record("d", 4.0, 0.5, proc="other")
    assert [s.name for s in other.spans] == ["a", "d"]


def test_log_handler_and_samples_match_jax():
    registry = {"jax": JM.MetricsRegistry(), "port": TM.MetricsRegistry()}
    recorders = {}
    for key, flight in (("jax", JF), ("port", TF)):
        registry[key].counter("events", labels={"kind": "x"}).inc(4)
        registry[key].gauge("level").set(2.5)
        registry[key].histogram("lat", buckets=(0.1, 1.0)).observe(0.5)
        recorders[key] = flight.FlightRecorder(
            name=key, registry=registry[key], families={"events", "lat",
                                                        "level"})
        recorders[key].sample_now()
    samples = [[(key_, value) for _, key_, value in recorders[key].samples]
               for key in ("jax", "port")]
    assert samples[1] == samples[0]
    assert ("lat{}:count", 1) in samples[1] or ("lat:count", 1) in samples[1]
    logger = logging.getLogger("serving.chaos.flight_test")
    handler = TF.FlightLogHandler()
    logger.addHandler(handler)
    try:
        logger.info("not captured")
        logger.warning("chaos %s: %s fault", "flight_test", "preemption")
    finally:
        logger.removeHandler(handler)
    assert [log[1:] for log in recorders["port"].logs] == [
        ("WARNING", "serving.chaos.flight_test",
         "chaos flight_test: preemption fault")]


def test_dump_on_alert_writes_one_dump_per_rule(tmp_path):
    recorder = feed(TF, TT, "dump")
    TF.register(recorder)
    dumper = TF.DumpOnAlert(tmp_path)

    class Rule:
        name = "ttft_p95"

    path = dumper(Rule(), {"exemplars": ["t7", "t9"]})
    assert dumper(Rule(), {"exemplars": ["t1"]}) is None   # latched
    document = json.loads(open(path).read())
    assert document["metadata"] == {"reason": "slo-breach:ttft_p95",
                                    "exemplars": ["t7", "t9"]}
    assert len(document["traceEvents"]) == 1 + 8 * 4


def test_fault_plan_records_each_injected_fault():
    recorder = TF.FlightRecorder(name="chaos")
    plan = TC.FaultPlan(seed=0)
    plan.drop(topic="a/#")
    plan.duplicate(topic="b/#")
    plan.partition([["x"], ["y"]], start=0.0, stop=10.0)
    plan.decide("a/in", "s", "r", b"", 1.0)
    plan.decide("b/in", "s", "r", b"", 2.0)
    plan.decide("c/in", "x", "y", b"", 3.0)
    plan.decide("c/in", "s", "r", b"", 4.0)       # no rule: no fault
    assert [fault[1:] for fault in recorder.faults] == [
        ("drop", "a/in", "s", "r"), ("duplicate", "b/in", "s", "r"),
        ("partitioned", "c/in", "x", "y")]
