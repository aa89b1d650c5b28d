"""The port's method tracing (trace.py) and legacy stream-element shim
(legacy.py) against the JAX package's, as tests/test_ui.py and
tests/test_observe.py exercise them: the same wrapped names, span names,
nesting, errors and untrace on both packages; thread-local nesting;
finished spans feeding the process Tracer under the ambient trace; the
print tracer's lines; and a 2020-era StreamElement running on each
package's pipeline with the same handler calls, states and outputs."""

import threading

import pytest

from aiko_services_tpu.pipeline import Pipeline as JPipeline
from aiko_services_tpu.pipeline import \
    parse_pipeline_definition as jparse
from aiko_services_tpu_torch.pipeline import Pipeline as TPipeline
from aiko_services_tpu_torch.pipeline import \
    parse_pipeline_definition as tparse

from torch_ops_host import PACKAGES, Host, both


class Thing:
    level = 3

    def outer(self, x):
        return self.inner(x) + 1

    def inner(self, x):
        return x * 2

    def broken(self):
        raise ValueError("no")

    @property
    def watched(self):
        raise AssertionError("a property getter must not run")

    def _private(self):
        return 0


def test_collector_spans_equal_jax():
    def scenario(package):
        trace = PACKAGES[package].trace
        thing = Thing()
        collector = trace.TraceCollector()
        wrapped = sorted(trace.trace_all_methods(thing, collector))
        result = thing.outer(5)
        with pytest.raises(ValueError):
            thing.broken()
        spans = collector.spans
        shape = [(s.name, None if s.parent_id is None else
                  [t.span_id for t in spans].index(s.parent_id), s.error,
                  s.duration is not None) for s in spans]
        trace.untrace(thing)
        thing.outer(1)
        only = trace.trace_all_methods(Thing(), collector, only=("inner",))
        return wrapped, result, shape, len(collector.spans), only, \
            repr(spans[0]).split(" ")[0]
    wrapped, result, shape, count, only, first = both(scenario)
    assert wrapped == ["broken", "inner", "outer"] and result == 11
    assert shape == [("outer", None, None, True), ("inner", 0, None, True),
                     ("broken", None, "ValueError('no')", True)]
    assert count == 3 and only == ["inner"] and first == "Span(outer"


def test_nesting_is_thread_local():
    def scenario(package):
        collector = PACKAGES[package].trace.TraceCollector()
        barrier = threading.Barrier(2)

        def outer_call(tag):
            def inner():
                barrier.wait(timeout=5)     # both outers open first
                return tag
            return collector(f"inner_{tag}", inner, (), {})

        threads = [threading.Thread(target=lambda t=t: collector(
            f"outer_{t}", outer_call, (t,), {})) for t in ("a", "b")]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=10)
        spans = {span.name: span for span in collector.spans}
        return sorted(spans), {
            tag: (spans[f"inner_{tag}"].parent_id ==
                  spans[f"outer_{tag}"].span_id,
                  spans[f"outer_{tag}"].parent_id)
            for tag in ("a", "b")}
    names, nesting = both(scenario)
    assert len(names) == 4
    assert nesting == {"a": (True, None), "b": (True, None)}


def test_finished_spans_feed_the_tracer_under_the_ambient_trace():
    def scenario(package):
        m = PACKAGES[package]
        tracer = m.tracing.tracer
        was_enabled = tracer.enabled
        tracer.enable()
        before = len(tracer.spans)
        try:
            context = m.tracing.new_trace()
            thing = Thing()
            m.trace.trace_all_methods(thing, m.trace.TraceCollector())
            with m.tracing.activate(context):
                thing.outer(2)
            recorded = list(tracer.spans)[before:]
        finally:
            if not was_enabled:
                tracer.disable()
        return [(s.name, s.cat, s.trace_id == context.trace_id,
                 s.parent_id == context.span_id, s.args) for s in recorded]
    assert both(scenario) == [
        ("call:inner", "method", True, True, {"error": ""}),
        ("call:outer", "method", True, True, {"error": ""})]


def test_print_tracer_lines(capsys):
    def scenario(package):
        trace = PACKAGES[package].trace
        thing = Thing()
        trace.trace_all_methods(thing, trace.print_tracer, only=("inner",))
        value = thing.inner(4)
        return value, capsys.readouterr().out
    assert both(scenario) == (8, "TRACE enter inner(4,)\nTRACE exit  inner\n")


PARSE = {"jax": (jparse, JPipeline), "torch": (tparse, TPipeline)}
DEFINITION = {
    "version": 0, "name": "p_legacy", "runtime": "python",
    "graph": ["(OldStyle)"],
    "elements": [{"name": "OldStyle", "input": [{"name": "number"}],
                  "output": [{"name": "doubled"}]}],
}


def test_legacy_stream_element_equals_jax():
    def scenario(package):
        legacy = PACKAGES[package].legacy
        parse, pipeline_class = PARSE[package]
        events = []

        class OldStyle(legacy.StreamElement):
            def stream_start_handler(self, stream, stream_id):
                events.append(("start", stream_id))
                return True, {}

            def stream_frame_handler(self, stream, frame_id, swag):
                events.append(("frame", frame_id, swag["number"]))
                if swag["number"] < 0:
                    return False, {}
                return True, {"doubled": swag["number"] * 2}

            def stream_stop_handler(self, stream, stream_id):
                events.append(("stop", stream_id))
                return True, {}

        host = Host(package)
        pipeline = pipeline_class(host.runtime("legacy_host"),
                                  parse(DEFINITION),
                                  element_classes={"OldStyle": OldStyle},
                                  stream_lease_time=0)
        stream = pipeline.create_stream("s1", lease_time=0)
        element = pipeline.graph.node("OldStyle").element
        states = [element.get_state(stream)]
        ok, swag = pipeline.process_frame("s1", {"number": 21})
        failed, _ = pipeline.process_frame("s1", {"number": -1})
        pipeline.destroy_stream("s1")
        states.append(element.get_state(stream))
        return states, ok, swag.get("doubled"), failed, events, \
            legacy.StreamElementState.COMPLETE

    states, ok, doubled, failed, events, complete = both(scenario)
    assert states == ["run", complete] and ok and doubled == 42
    assert not failed
    assert events == [("start", "s1"), ("frame", 0, 21), ("frame", 1, -1),
                      ("stop", "s1")]


def test_a_failing_start_handler_refuses_the_stream():
    def scenario(package):
        legacy = PACKAGES[package].legacy
        parse, pipeline_class = PARSE[package]

        class Refuses(legacy.StreamElement):
            def stream_start_handler(self, stream, stream_id):
                return False, {}

        host = Host(package)
        pipeline = pipeline_class(host.runtime("refuse_host"),
                                  parse(DEFINITION),
                                  element_classes={"OldStyle": Refuses},
                                  stream_lease_time=0)
        with pytest.raises(Exception) as refused:
            pipeline.create_stream("s1", lease_time=0)
        return type(refused.value).__name__, str(refused.value), \
            "s1" in pipeline.streams
    kind, message, kept = both(scenario)
    assert kind == "PipelineError" and not kept
    assert "stream_start_handler failed" in message
