"""The port's pipeline framework (definition loader, DAG walk, streams,
deferred resume, failure budgets, stream leases) held against the JAX
package's: the same definitions load alike, and the same small DAG,
defined once per package on its own engine, gives equal swags, frame
orders and stream lifecycles under a virtual clock."""

import copy
import glob
import json

import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

PACKAGES = {"jax": (JE, JM, JProcessRuntime, JP),
            "torch": (TE, TM, TProcessRuntime, TP)}
EXAMPLES = sorted(glob.glob("examples/**/pipeline_*.json", recursive=True))


def _runtime(package):
    event, memory, runtime_class, _ = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
        return memory.MemoryMessage(
            on_message=on_message, broker=broker, lwt_topic=lwt_topic,
            lwt_payload=lwt_payload, lwt_retain=lwt_retain)
    return runtime_class(name="host", engine=engine, namespace="test",
                         process_id="host",
                         transport_factory=factory).initialize()


def _outcome(module, data):
    try:
        definition = module.parse_pipeline_definition(copy.deepcopy(data))
    except module.PipelineError as exc:
        return "rejected", str(exc)
    return "accepted", module.definition_to_dict(definition)


@pytest.mark.parametrize("path", EXAMPLES)
def test_example_definitions_load_alike(path):
    with open(path) as f:
        data = json.load(f)
    port = _outcome(TP, data)
    assert port == _outcome(JP, data)
    assert port[0] == "accepted"
    # definition_to_dict round-trips through the loader
    again = TP.definition_to_dict(TP.parse_pipeline_definition(port[1]))
    assert again == port[1]
    assert TP.definition_to_dict(TP.load_pipeline_definition(path)) == \
        port[1]


@pytest.mark.parametrize("mutation", [
    lambda d: d.pop("graph"),
    lambda d: d.update(version=1),
    lambda d: d.update(runtime="cuda"),
    lambda d: d.update(graph=[]),
    lambda d: d["elements"].append(dict(d["elements"][0])),
    lambda d: d["elements"][0].update(deploy={"local": {}}),
    lambda d: d["elements"][0].update(deploy={"remote": {}}),
    lambda d: d["elements"][0].update(contracts={"audio": 3}),
    lambda d: d["elements"][0]["output"].append({"type": "x"}),
])
def test_malformed_definitions_are_rejected_alike(mutation):
    with open("examples/speech/pipeline_transcription.json") as f:
        data = json.load(f)
    mutation(data)
    port = _outcome(TP, data)
    assert port[0] == "rejected" and port == _outcome(JP, data)


# -- a small DAG, defined once per package -------------------------------------

DAG = {
    "version": 0, "name": "p_dag", "runtime": "python",
    # PE_Split fans out: its `x` reaches PE_Add as `a`, PE_Mul as `b`;
    # PE_Join fans in both results
    "graph": ["(PE_Source (PE_Split (PE_Add (x: a) PE_Join) "
              "(PE_Mul (x: b) PE_Join)))"],
    "parameters": {"PE_Mul.factor": 3, "increment": 10},
    "elements": [
        {"name": "PE_Source", "input": [], "output": [{"name": "value"}]},
        {"name": "PE_Split", "input": [{"name": "value"}],
         "output": [{"name": "x"}]},
        {"name": "PE_Add", "input": [{"name": "a"}],
         "output": [{"name": "sum"}]},
        {"name": "PE_Mul", "input": [{"name": "b"}],
         "output": [{"name": "product"}, {"name": "scratch"}]},
        {"name": "PE_Join", "input": [{"name": "sum"}, {"name": "product"}],
         "output": [{"name": "joined"}]},
    ],
}


def _element_classes(package, log, defer=(), fail=()):
    """The DAG's elements over `package`'s PipelineElement: PE_Mul parks
    frames whose value is in `defer` (resumed 0.5 s later by a oneshot)
    and PE_Add fails frames whose value is in `fail`."""
    module = PACKAGES[package][3]
    base, output = module.PipelineElement, module.FrameOutput

    class PE_Source(base):
        def process_frame(self, frame, **_):
            return output(True, {"value": frame.swag["seed"] * 2})

    class PE_Split(base):
        def process_frame(self, frame, value=0, **_):
            return output(True, {"x": value + 1})

    class PE_Add(base):
        def process_frame(self, frame, a=0, **_):
            increment, _ = self.get_parameter("increment", 0, frame.stream)
            if frame.swag["value"] in fail:
                return output(False, diagnostic="odd frame")
            return output(True, {"sum": a + int(increment)})

    class PE_Mul(base):
        def process_frame(self, frame, b=0, **_):
            factor, _ = self.get_parameter("factor", 1, frame.stream)
            outputs = {"product": b * int(factor), "scratch": "kept"}
            if frame.swag["value"] not in defer:
                return output(True, outputs)
            log.append(("park", frame.stream_id, frame.frame_id))
            self.runtime.event.add_oneshot_handler(
                lambda: self.pipeline.post("resume_frame", frame,
                                           "PE_Mul", outputs), 0.5)
            return output(True, module.DEFERRED)

    class PE_Join(base):
        def process_frame(self, frame, sum=0, product=0, **_):
            return output(True, {"joined": [sum, product]})

        def stop_stream(self, stream):
            log.append(("stop", stream.stream_id))

    return {cls.__name__: cls for cls in
            (PE_Source, PE_Split, PE_Add, PE_Mul, PE_Join)}


def _drive(package, frames, streams=("s0",), lease_time=0.0, budget=1,
           defer=(), fail=(), idle=0.0, stream_parameters=None):
    """Create `streams`, post `frames` ((stream, seed) in order), run the
    engine until it idles `idle` seconds after the last frame, and return
    what the pipeline did."""
    runtime = _runtime(package)
    engine = runtime.event
    log = []
    pipeline = PACKAGES[package][3].Pipeline(
        runtime, PACKAGES[package][3].parse_pipeline_definition(
            copy.deepcopy(DAG)),
        element_classes=_element_classes(package, log, defer, fail),
        stream_lease_time=lease_time, stream_failure_budget=budget)
    pipeline.add_frame_handler(lambda frame: log.append(
        ("done", frame.stream_id, frame.frame_id,
         {k: v for k, v in sorted(frame.swag.items())},
         sorted(k for k in frame.metrics if k.startswith("time_")))))
    for stream_id in streams:
        pipeline.create_stream(stream_id,
                               parameters=dict(stream_parameters or {}))
    for stream_id, seed in frames:
        pipeline.post("process_frame", stream_id, {"seed": seed})
        engine.clock.advance(0.1)
        while engine.step():
            pass
    PACKAGES[package][0].settle_virtual(engine, idle, tick=0.05)
    leftover = [h for h in engine.live_timer_handlers()
                if getattr(h, "__self__", None).__class__.__name__
                == "Lease"]
    stats = {kind: pipeline.recovery_stats[kind]
             for kind in ("frames_failed", "streams_stopped")}
    return log, sorted(pipeline.streams), stats, len(leftover)


def test_fan_out_and_fan_in_renames_give_equal_swags():
    frames = [("s0", 1), ("s1", 2), ("s0", 3)]
    port = _drive("torch", frames, streams=("s0", "s1"),
                  stream_parameters={"PE_Mul.factor": 5})
    assert port == _drive("jax", frames, streams=("s0", "s1"),
                          stream_parameters={"PE_Mul.factor": 5})
    log = port[0]
    _, stream_id, frame_id, swag, times = log[0]
    # seed 1: value 2, x 3, sum 3 + 10, product 3 * 5 (stream beats
    # pipeline parameters); PE_Mul's undeclared scratch is dropped
    assert (stream_id, frame_id) == ("s0", 0)
    assert swag == {"seed": 1, "value": 2, "x": 3, "a": 3, "b": 3,
                    "sum": 13, "product": 15, "scratch": "kept",
                    "joined": [13, 15]}
    assert times == ["time_PE_Add", "time_PE_Join", "time_PE_Mul",
                     "time_PE_Source", "time_PE_Split", "time_pipeline",
                     "time_pipeline_start"]


def test_deferred_frames_resume_in_order_alike():
    frames = [("s0", seed) for seed in range(5)]
    port = _drive("torch", frames, defer={2, 6}, idle=1.0)
    assert port == _drive("jax", frames, defer={2, 6}, idle=1.0)
    order = [(entry[0], entry[2]) for entry in port[0]]
    # frames 1 and 3 (values 2 and 6) park and finish after the others
    assert order == [("done", 0), ("park", 1), ("done", 2), ("park", 3),
                     ("done", 4), ("done", 1), ("done", 3)]


@pytest.mark.parametrize("budget", [1, 2, 3])
def test_stream_failure_budget_alike(budget):
    # values 0 2 6 8 10 12 14 16; PE_Add fails 2, 6 (two in a row), then
    # 10, 12 (two in a row after a success)
    frames = [("s0", seed) for seed in (0, 1, 3, 4, 5, 6, 7, 8)]
    fail = {2, 6, 10, 12}
    port = _drive("torch", frames, budget=budget, fail=fail)
    assert port == _drive("jax", frames, budget=budget, fail=fail)
    log, streams, stats, _ = port
    assert stats["frames_failed"] == {1: 1, 2: 2, 3: 4}[budget]
    assert stats["streams_stopped"] == (1 if budget <= 2 else 0)
    assert streams == ([] if budget <= 2 else ["s0"])


def test_stream_leases_expire_on_the_virtual_clock_alike():
    frames = [("s0", 1), ("s1", 2), ("s0", 3)]
    port = _drive("torch", frames, streams=("s0", "s1", "s2"),
                  lease_time=1.0, idle=0.75)
    assert port == _drive("jax", frames, streams=("s0", "s1", "s2"),
                          lease_time=1.0, idle=0.75)
    log, streams, _, leases = port
    # s2 never had a frame: created at 0, expired at 1.0; s1's last
    # frame at 0.1 keeps it to 1.1 and s0's at 0.2 to 1.2 — the settle
    # ends at 1.05
    assert streams == ["s0", "s1"] and leases == 2
    assert ("stop", "s2") in log
    longer = _drive("torch", frames, streams=("s0", "s1"), lease_time=1.0,
                    idle=2.0)
    assert longer[1] == [] and longer[3] == 0
    assert sorted(e for e in longer[0] if e[0] == "stop") == \
        [("stop", "s0"), ("stop", "s1")]


def test_unknown_streams_missing_inputs_and_bad_resumes():
    runtime = _runtime("torch")
    log = []
    pipeline = TP.Pipeline(runtime, TP.parse_pipeline_definition(
        copy.deepcopy(DAG)), element_classes=_element_classes("torch", log),
        stream_lease_time=0)
    assert pipeline.process_frame("nope", {"seed": 1}).diagnostic == \
        "unknown stream"
    result = pipeline.process_frame("*", {"seed": 1})   # auto-created
    assert result.ok and result.outputs["joined"] == [13, 9]
    stream = pipeline.create_stream("s")
    frame = TP.Frame(stream=stream, frame_id=0)
    assert pipeline.resume_frame(frame, "PE_Mul", {}).diagnostic == \
        "frame not deferred"
    with pytest.raises(TP.PipelineError, match="stream exists"):
        pipeline.create_stream("s")
    with pytest.raises(TP.PipelineError, match="not produced"):
        bad = copy.deepcopy(DAG)
        bad["elements"][4]["input"].append({"name": "missing"})
        TP.Pipeline(runtime, TP.parse_pipeline_definition(bad),
                    element_classes=_element_classes("torch", log))
    pipeline.stop()
    assert runtime.service_by_name("p_dag") is None
    assert np.all([h.__class__.__name__ != "Lease"
                   for h in runtime.event.live_timer_handlers()])
