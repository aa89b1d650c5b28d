"""Remote pipeline hops on the port held against the JAX package: the
scenarios of tests/test_remote_pipeline.py (request/response, discovery
swap, timeout, one-way, a tensor across the binary wire, a codec hint,
burst coalescing, the text-transport fallback through PE_DataEncode /
PE_DataDecode, identity elision), plus retries with a retry seed,
failover to a second candidate, frame deadlines on the wire, and
duplicate-request replay from the reply cache.  Each scenario runs once
per package — registrar, serving and calling runtimes on one broker and
one engine under a virtual clock, with the same process ids — and both
runs must give the same swags, recovery_stats, wire counters and send
times.  Hop ids carry a random nonce, so frames are compared by (stream,
frame)."""

import numpy as np
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.observe import metrics as JMetrics
from aiko_services_tpu.observe import tracing as JTracing
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu.share import ServicesCache as JServicesCache
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.observe import metrics as TMetrics
from aiko_services_tpu_torch.observe import tracing as TTracing
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.share import ServicesCache as TServicesCache
from aiko_services_tpu_torch.transport import memory as TM

PACKAGES = {
    "jax": dict(event=JE, memory=JM, runtime=JProcessRuntime, pipeline=JP,
                registrar=JRegistrar, cache=JServicesCache,
                metrics=JMetrics, tracing=JTracing),
    "torch": dict(event=TE, memory=TM, runtime=TProcessRuntime, pipeline=TP,
                  registrar=TRegistrar, cache=TServicesCache,
                  metrics=TMetrics, tracing=TTracing),
}


def element(name, inputs=(), outputs=(), deploy=None):
    return {"name": name, "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "parameters": {}, "deploy": deploy or {}}


def remote(name):
    return {"remote": {"service_filter": {"name": name}}}


def classes(package):
    """The scenarios' elements, as subclasses of the package's
    PipelineElement.  The port's source emits a torch tensor: it crosses
    the wire as the numpy array of its values."""
    P = PACKAGES[package]["pipeline"]
    tracing = PACKAGES[package]["tracing"]

    def make(name, fn):
        return type(name, (P.PipelineElement,), {
            "process_frame": lambda self, frame, **inputs:
                P.FrameOutput(True, fn(self, frame, **inputs))})

    def tensor(_self, _frame, **_):
        values = np.arange(6, dtype=np.float32)
        return {"data": torch.from_numpy(values) if package == "torch"
                else values}

    def budget(self, frame, **_):
        context = tracing.current_trace()
        now = self.runtime.event.clock.now()
        return {"budget": None if context is None
                else round(context.remaining(now), 6)}

    return {
        "PE_MakeTensor": make("PE_MakeTensor", tensor),
        "PE_TensorTotal": make("PE_TensorTotal", lambda s, f, data=None, **_:
                               {"total": float(np.asarray(data).sum())}),
        "PE_TensorDouble": make(
            "PE_TensorDouble", lambda s, f, data=None, **_:
            {"doubled": np.asarray(data) * 2.0,
             "total": float(np.asarray(data).sum())}),
        "PE_UseTotal": make("PE_UseTotal", lambda s, f, total=0, **_:
                            {"final": float(total) + 0.5}),
        "PE_After": make("PE_After", lambda s, f, **_: {"tail_ran": True}),
        "PE_PassThrough": make("PE_PassThrough",
                               lambda s, f, data=None, **_: {"data": data}),
        "PE_RawSource": make("PE_RawSource", lambda s, f, **_: {
            "raw": np.arange(4, dtype=np.float32)}),
        "PE_Consume": make("PE_Consume", lambda s, f, data=None, **_: {
            "got": float(np.asarray(data).sum())}),
        "PE_Budget": make("PE_Budget", budget),
    }


SERVING = {
    "serve_pipe": (["(PE_DataDecode (PE_TensorTotal))"],
                   [element("PE_DataDecode", ["data"], ["data"]),
                    element("PE_TensorTotal", ["data"], ["total"])]),
    "serve_bin": (["(PE_TensorDouble)"],
                  [element("PE_TensorDouble", ["data"],
                           ["doubled", "total"])]),
    "serve_pass": (["(PE_PassThrough)"],
                   [element("PE_PassThrough", ["data"], ["data"])]),
    "serve_budget": (["(PE_Budget)"],
                     [element("PE_Budget", ["data"], ["budget"])]),
}
CALLING = {
    "call_pipe": (["(PE_MakeTensor (PE_DataEncode (remote_total "
                   "(PE_UseTotal))))"],
                  [element("PE_MakeTensor", [], ["data"]),
                   element("PE_DataEncode", ["data"], ["data"]),
                   element("remote_total", ["data"], ["total"],
                           remote("serve_pipe")),
                   element("PE_UseTotal", ["total"], ["final"])]),
    "call_bin": (["(PE_MakeTensor (remote_double (PE_UseTotal)))"],
                 [element("PE_MakeTensor", [], ["data"]),
                  element("remote_double", ["data"], ["doubled", "total"],
                          remote("serve_bin")),
                  element("PE_UseTotal", ["total"], ["final"])]),
    "oneway": (["(PE_MakeTensor (PE_DataEncode (remote_sink) (PE_After)))"],
               [element("PE_MakeTensor", [], ["data"]),
                element("PE_DataEncode", ["data"], ["data"]),
                element("remote_sink", ["data"], [], remote("serve_pipe")),
                element("PE_After", ["data"], ["tail_ran"])]),
    "call_pass": (["(PE_RawSource (remote_pass (raw: data) (PE_Consume)))"],
                  [element("PE_RawSource", [], ["raw"]),
                   element("remote_pass", ["data"], ["data"],
                           remote("serve_pass")),
                   element("PE_Consume", ["data"], ["got"])]),
    "call_budget": (["(PE_MakeTensor (remote_budget))"],
                    [element("PE_MakeTensor", [], ["data"]),
                     element("remote_budget", ["data"], ["budget"],
                             remote("serve_budget"))]),
}


def definition(P, name, table):
    graph, elements = table[name]
    return P.parse_pipeline_definition({
        "version": 0, "name": name, "runtime": "python", "graph": graph,
        "elements": elements})


class System:
    """One package's registrar, serving and calling runtimes on one
    broker and one engine under a virtual clock."""

    def __init__(self, package, text_only=False):
        self.package = package
        self.m = PACKAGES[package]
        self.engine = self.m["event"].EventEngine(
            self.m["event"].VirtualClock())
        self.broker = self.m["memory"].MemoryBroker()
        memory = self.m["memory"]

        class TextOnlyMessage(memory.MemoryMessage):
            BINARY = False
        self.message_class = TextOnlyMessage if text_only \
            else memory.MemoryMessage
        self.classes = classes(package)
        self.sent = []          # (clock, kind) of every message spied on
        # each calling pipeline's wire counters before its frames run:
        # the counters live in the package's process-wide registry, which
        # another test in this process may have counted into under the
        # same pipeline name
        self.wire_start = {}
        self.m["registrar"](self.runtime("reg_host"))
        self.engine.clock.advance(2.1)
        self.settle()

    def runtime(self, name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return self.message_class(
                on_message=on_message, broker=self.broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain)
        return self.m["runtime"](name=name, engine=self.engine,
                                 namespace="test", process_id=name,
                                 transport_factory=factory).initialize()

    def settle(self, steps=40):
        for _ in range(steps):
            while self.engine.step():
                pass

    def serve(self, name, host="serve_host", **kwargs):
        runtime = self.runtime(host)
        P = self.m["pipeline"]
        pipeline = P.Pipeline(runtime, definition(P, name, SERVING),
                              element_classes=self.classes,
                              auto_create_streams=True,
                              stream_lease_time=0, **kwargs)
        served = []
        pipeline.add_frame_handler(served.append)
        self.settle()
        return runtime, pipeline, served

    def call(self, name, **kwargs):
        runtime = self.runtime("call_host")
        P = self.m["pipeline"]
        kwargs.setdefault("remote_timeout", 10.0)
        caller = P.Pipeline(runtime, definition(P, name, CALLING),
                            element_classes=self.classes,
                            services_cache=self.m["cache"](runtime),
                            stream_lease_time=0, **kwargs)
        self.done = []
        caller.add_frame_handler(self.done.append)
        self.settle()
        self.wire_start[name] = self.wire(name)
        return runtime, caller

    def spy(self, topic):
        """Record (engine clock, payload kind) of every message on
        `topic`."""
        def seen(_topic, payload):
            self.sent.append((round(self.engine.clock.now(), 6),
                              "bytes" if isinstance(payload, bytes)
                              else "text"))
        client = self.m["memory"].MemoryMessage(on_message=seen,
                                                broker=self.broker)
        client.connect()
        client.subscribe(topic)

    def frames(self, caller, count=1, prefix="s"):
        for index in range(count):
            caller.create_stream(f"{prefix}{index}", lease_time=0)
            caller.post("process_frame", f"{prefix}{index}", {})

    def wire(self, name):
        registry = self.m["metrics"].default_registry()
        return {f"{direction}_{kind}": registry.value(
                    f"pipeline_wire_{kind}_total",
                    {"pipeline": name, "direction": direction})
                for direction in ("request", "reply")
                for kind in ("envelopes", "frames")}


def plain(value):
    """A swag value in a form both packages' results compare in."""
    if isinstance(value, torch.Tensor):
        value = value.numpy()
    if isinstance(value, np.ndarray):
        return ("array", str(value.dtype), value.tolist())
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    return value


def outcome(system, caller, wire_before=None, served=()):
    """The scenario's result; its wire counts are those since
    `wire_before` (default: since the caller was made)."""
    wire = system.wire(caller.name)
    if wire_before is None:
        wire_before = system.wire_start[caller.name]
    wire = {k: wire[k] - wire_before[k] for k in wire}
    return {
        "done": sorted(((f.stream_id, f.frame_id, plain(f.swag))
                        for f in system.done), key=str),
        "served": sorted(((f.stream_id, f.frame_id) for f in served)),
        "recovery": dict(caller.recovery_stats),
        "pending": len(caller._pending_remote),
        "streams": sorted(caller.streams),
        "wire": wire,
        "sent": list(system.sent),
    }


def both(scenario):
    """Run a scenario on both packages; their outcomes must be equal."""
    port, reference = scenario("torch"), scenario("jax")
    assert port == reference
    return port


# ---------------------------------------------------------------------------
# The scenarios of tests/test_remote_pipeline.py
# ---------------------------------------------------------------------------

def test_request_response_across_runtimes():
    def scenario(package):
        system = System(package)
        system.serve("serve_pipe")
        _, caller = system.call("call_pipe")
        assert caller.remote_elements_ready()
        before = system.wire(caller.name)
        system.frames(caller)
        system.settle()
        return outcome(system, caller, before)
    result = both(scenario)
    (_, _, swag), = result["done"]
    assert swag["total"] == "15.0" and swag["final"] == 15.5
    assert result["pending"] == 0
    # PE_DataEncode made the tensor text: no binary envelope went out
    assert result["wire"]["request_frames"] == 1


def test_discovery_swap_both_directions():
    def scenario(package):
        system = System(package)
        serve_rt, serving, _ = system.serve("serve_pipe")
        _, caller = system.call("call_pipe")
        placeholder = caller._remote["remote_total"]
        found = [placeholder.found]
        serving.stop()
        serve_rt.terminate()
        system.settle()
        found.append(placeholder.found)
        caller.create_stream("s2", lease_time=0)
        ok, _ = caller.process_frame("s2", {})
        system.serve("serve_pipe", host="serve_host2")
        found.append(placeholder.found)
        system.frames(caller, prefix="t")
        system.settle()
        return found, ok, outcome(system, caller)
    found, ok, result = both(scenario)
    assert found == [True, False, True] and not ok
    assert "s2" not in result["streams"]
    assert result["done"][0][2]["final"] == 15.5


def test_hop_times_out_without_reply():
    def scenario(package):
        system = System(package)
        _, serving, _ = system.serve("serve_pipe")
        serving.process_frame_remote = lambda *args, **kwargs: None
        _, caller = system.call("call_pipe")
        system.frames(caller)
        system.settle()
        pending = len(caller._pending_remote)
        system.engine.clock.advance(11.0)          # > remote_timeout
        system.settle()
        return pending, outcome(system, caller)
    pending, result = both(scenario)
    assert pending == 1 and result["pending"] == 0
    assert result["streams"] == [] and result["done"] == []
    assert result["recovery"]["frames_failed"] == 1


def test_one_way_when_no_outputs_declared():
    def scenario(package):
        system = System(package)
        _, _, served = system.serve("serve_pipe")
        _, caller = system.call("oneway")
        system.frames(caller)
        system.settle()
        return outcome(system, caller, served=served), \
            [float(f.swag["total"]) for f in served]
    result, totals = both(scenario)
    assert result["done"][0][2]["tail_ran"] is True
    assert totals == [15.0] and result["pending"] == 0


def test_tensor_crosses_the_binary_wire_and_back():
    def scenario(package):
        system = System(package)
        _, serving, served = system.serve("serve_bin")
        system.spy(f"{serving.topic_path}/in")
        _, caller = system.call("call_bin")
        before = system.wire(caller.name)
        system.frames(caller)
        system.settle()
        return outcome(system, caller, before, served)
    result = both(scenario)
    swag = result["done"][0][2]
    assert swag["doubled"] == ("array", "float32",
                               [0.0, 2.0, 4.0, 6.0, 8.0, 10.0])
    assert swag["final"] == 15.5
    assert [kind for _, kind in result["sent"]] == ["bytes"]
    assert result["wire"] == {"request_envelopes": 1, "request_frames": 1,
                              "reply_envelopes": 0, "reply_frames": 0}


def test_codec_hint_applies():
    def scenario(package):
        system = System(package)
        system.serve("serve_bin")
        _, caller = system.call("call_bin",
                                remote_wire_codecs={"data": "i8"})
        system.frames(caller)
        system.settle()
        return outcome(system, caller)
    result = both(scenario)
    doubled = np.array(result["done"][0][2]["doubled"][2])
    original = np.arange(6, dtype=np.float32)
    assert np.abs(doubled - original * 2.0).max() <= \
        2 * original.max() / 127 + 1e-6


def test_burst_coalesces_into_fewer_envelopes():
    def scenario(package):
        system = System(package)
        _, serving, served = system.serve("serve_bin")
        system.spy(f"{serving.topic_path}/in")
        _, caller = system.call("call_bin")
        before = system.wire(caller.name)
        system.frames(caller, 8)
        system.settle(80)
        return outcome(system, caller, before, served)
    result = both(scenario)
    assert len(result["done"]) == 8 and result["pending"] == 0
    assert 1 <= len(result["sent"]) < 8
    assert result["wire"]["request_frames"] == 8
    assert result["wire"]["request_envelopes"] == len(result["sent"])


def test_text_transport_falls_back_to_sexpr():
    def scenario(package):
        system = System(package, text_only=True)
        _, serving, _ = system.serve("serve_pipe")
        system.spy(f"{serving.topic_path}/in")
        _, caller = system.call("call_pipe")
        system.frames(caller, 3)
        system.settle()
        return outcome(system, caller)
    result = both(scenario)
    assert [swag["final"] for _, _, swag in result["done"]] == [15.5] * 3
    # one text message per frame: no coalescing without the envelope
    assert [kind for _, kind in result["sent"]] == ["text"] * 3


def test_identity_passthrough_survives_reply_elision():
    def scenario(package):
        system = System(package)
        system.serve("serve_pass")
        _, caller = system.call("call_pass")
        system.frames(caller)
        system.settle()
        return outcome(system, caller)
    result = both(scenario)
    assert result["done"][0][2]["got"] == 6.0


# ---------------------------------------------------------------------------
# Recovery: retries, failover, deadlines, duplicate replay
# ---------------------------------------------------------------------------

def _swallow(pipeline, count):
    """Drop the first `count` requests the serving pipeline receives."""
    original = pipeline.process_frame_remote
    state = {"left": count}

    def maybe(*args, **kwargs):
        if state["left"] > 0:
            state["left"] -= 1
            return None
        return original(*args, **kwargs)
    pipeline.process_frame_remote = maybe


def test_retries_resend_at_the_seeded_backoff_times():
    def scenario(package):
        system = System(package)
        _, serving, served = system.serve("serve_bin")
        _swallow(serving, 2)
        system.spy(f"{serving.topic_path}/in")
        _, caller = system.call("call_bin", remote_timeout=1.0,
                                remote_retries=3, retry_seed=11)
        system.frames(caller)
        for _ in range(400):
            system.settle(2)
            system.engine.clock.advance(0.01)
        return outcome(system, caller, served=served)
    result = both(scenario)
    assert result["recovery"]["retries"] == 2
    assert len(result["done"]) == 1 and len(result["sent"]) == 3
    times = [t for t, _ in result["sent"]]
    # timeout 1.0, then a jittered backoff of 0.25 x 2^n (1 + 0.25 u)
    assert 1.25 <= times[1] - times[0] <= 1.32
    assert 1.5 <= times[2] - times[1] <= 1.63


def test_failover_to_a_second_candidate():
    def scenario(package):
        system = System(package)
        _, first, _ = system.serve("serve_bin")
        _swallow(first, 100)                     # wedged
        _, second, served = system.serve("serve_bin", host="serve_host2")
        _, caller = system.call("call_bin", remote_timeout=1.0,
                                remote_retries=2, retry_seed=3)
        active = caller._remote["remote_double"].topic_path
        system.frames(caller)
        for _ in range(400):
            system.settle(2)
            system.engine.clock.advance(0.01)
        return active, caller._remote["remote_double"].topic_path, \
            outcome(system, caller, served=served)
    active, now_active, result = both(scenario)
    assert active.endswith("serve_host/1")
    assert now_active.endswith("serve_host2/1")
    assert result["recovery"]["failovers"] == 1
    assert result["recovery"]["retries"] == 1
    assert result["served"] == [("s0", 0)] and len(result["done"]) == 1


def test_frame_deadline_rides_the_wire():
    def scenario(package):
        system = System(package)
        system.serve("serve_budget")
        _, caller = system.call("call_budget", frame_deadline=5.0)
        system.frames(caller)
        system.settle()
        return outcome(system, caller)
    result = both(scenario)
    # the serving walk ran under the caller's deadline (no time passed
    # on the virtual clock)
    assert float(result["done"][0][2]["budget"]) == 5.0   # sexpr: a string


def test_exhausted_deadline_fails_the_frame_before_the_timeout():
    def scenario(package):
        system = System(package)
        _, serving, _ = system.serve("serve_bin")
        _swallow(serving, 100)
        _, caller = system.call("call_bin", remote_timeout=10.0,
                                remote_retries=3, retry_seed=5,
                                frame_deadline=0.5)
        system.frames(caller)
        failed_at = None
        for _ in range(200):
            system.settle(2)
            if failed_at is None and caller.recovery_stats[
                    "frames_failed"]:
                failed_at = round(system.engine.clock.now(), 6)
            system.engine.clock.advance(0.01)
        return failed_at, outcome(system, caller)
    failed_at, result = both(scenario)
    assert result["recovery"]["deadline_exceeded"] == 1
    assert result["recovery"]["retries"] == 0
    assert result["recovery"]["frames_failed"] == 1
    # the hop lease never outlives the frame's 0.5 s budget
    assert 2.1 + 0.5 <= failed_at <= 2.1 + 0.6 + 0.1


def test_duplicate_request_replays_the_cached_reply():
    def scenario(package):
        system = System(package)
        _, serving, served = system.serve("serve_bin")
        call_rt, caller = system.call("call_bin")
        topic_in = f"{serving.topic_path}/in"
        original = call_rt.message.publish

        def twice(topic, payload, retain=False, wait=False):
            original(topic, payload, retain=retain, wait=wait)
            if topic == topic_in:
                original(topic, payload, retain=retain, wait=wait)
        call_rt.message.publish = twice
        system.frames(caller)
        system.settle()
        return outcome(system, caller, served=served), \
            dict(serving.recovery_stats)
    result, serving_stats = both(scenario)
    assert len(result["done"]) == 1 and result["served"] == [("s0", 0)]
    assert serving_stats["dup_requests"] == 1
    assert serving_stats["replayed_replies"] == 1
    assert result["recovery"]["dup_replies"] == 1


# ---------------------------------------------------------------------------
# The port's own: a value the wire refuses fails the frame at once
# ---------------------------------------------------------------------------

def test_a_wire_refusal_fails_the_frame_without_waiting_out_the_lease():
    """An illegal codec for the tensor (i8mel wants rank 2): the port
    fails the hop at once with the WireError, counted in frames_failed,
    and nothing is published.  (The JAX package raises out of the send
    and leaves the hop to time out: ROADMAP.md Queue 3.)"""
    system = System("torch")
    _, serving, served = system.serve("serve_bin")
    system.spy(f"{serving.topic_path}/in")
    _, caller = system.call("call_bin", remote_wire_codecs={"data": "i8mel"})
    before = system.wire(caller.name)
    stream = caller.create_stream("s0", lease_time=0)
    caller.post("process_frame", "s0", {})
    system.settle()
    result = outcome(system, caller, before, served)
    assert result["recovery"]["frames_failed"] == 1
    assert result["pending"] == 0 and result["done"] == []
    assert result["sent"] == [] and result["served"] == []
    assert result["wire"]["request_envelopes"] == 0
    assert "WireError" in stream.last_diagnostic
    assert result["streams"] == []          # its failure budget was 1
    assert not [h for h in system.engine.live_timer_handlers()
                if type(getattr(h, "__self__", None)).__name__ == "Lease"]
