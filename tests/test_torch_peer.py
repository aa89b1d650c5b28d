"""The peer data plane on the port held against the JAX package: the
scenarios of tests/test_peer.py (pins with the broker flat, no peer on
the serving side, refusal, stale nonce, duplicate accepts and opens,
dropped accepts, channel death mid-stream, failover renegotiation, chaos
drops recovered by retries, teardown, reply-pin attachment over a shared
channel, the redial that re-pins every negotiator) and a TCP round trip;
then examples/speech/pipeline_transcription_remote.json with its hop over
TCP peer channels (test_torch_remote_speech.py's setup), tokens equal to
JAX's for every (stream, frame).  Each scenario runs once per package —
registrar, serving and calling runtimes on one broker and one engine
under a virtual clock, with the same names — and both runs must give
the same frames, peer counters, pins, broker traffic and
recovery_stats.  Handshake ids and nonces are random, so the outcomes
hold counts and flags, never ids."""

import time

import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu.share import ServicesCache as JServicesCache
from aiko_services_tpu.transport import chaos as JC
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu.transport import peer as JPeer
from aiko_services_tpu.transport import wire as JW
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.share import ServicesCache as TServicesCache
from aiko_services_tpu_torch.transport import chaos as TC
from aiko_services_tpu_torch.transport import memory as TM
from aiko_services_tpu_torch.transport import peer as TPeer
from aiko_services_tpu_torch.transport import wire as TW

import test_torch_remote_speech as RS
from test_torch_remote_speech import weights  # noqa: F401  (a fixture)

PACKAGES = {
    "jax": dict(event=JE, memory=JM, runtime=JProcessRuntime, pipeline=JP,
                registrar=JRegistrar, cache=JServicesCache, chaos=JC,
                peer=JPeer, wire=JW),
    "torch": dict(event=TE, memory=TM, runtime=TProcessRuntime, pipeline=TP,
                  registrar=TRegistrar, cache=TServicesCache, chaos=TC,
                  peer=TPeer, wire=TW),
}
STATS = ("sent", "received", "fallback", "handshakes", "accepted",
         "refused", "rejected_stale", "dup_accepts", "closed",
         "renegotiations", "expired_handshakes", "attach_requests",
         "attach_pins", "attach_acks")


def both(scenario):
    """Run a scenario on both packages; their outcomes must be equal."""
    port, reference = scenario("torch"), scenario("jax")
    assert port == reference
    return port


def element(name, inputs=(), outputs=(), deploy=None):
    return {"name": name, "input": [{"name": n} for n in inputs],
            "output": [{"name": n} for n in outputs],
            "deploy": deploy or {}}


def classes(P):
    def make(name, fn):
        return type(name, (P.PipelineElement,), {
            "process_frame": lambda self, frame, **inputs:
                P.FrameOutput(True, fn(**inputs))})
    return {"PE_Src": make("PE_Src", lambda **_: {
                "data": np.arange(8, dtype=np.float32)}),
            "PE_Double": make("PE_Double", lambda data=None, **_: {
                "out": np.asarray(data) * 2.0})}


def serving_definition(P):
    return P.parse_pipeline_definition({
        "version": 0, "name": "serve", "runtime": "python",
        "graph": ["(PE_Double)"],
        "elements": [element("PE_Double", ["data"], ["out"])]})


def calling_definition(P):
    return P.parse_pipeline_definition({
        "version": 0, "name": "call", "runtime": "python",
        "graph": ["(PE_Src (hop))"],
        "elements": [
            element("PE_Src", (), ["data"]),
            element("hop", ["data"], ["out"],
                    deploy={"remote": {"service_filter":
                                       {"name": "serve"}}})]})


class System:
    """Registrar + N peer-enabled serving runtimes + a peer-enabled
    caller of one package, on one broker and one virtual-clock engine
    (tests/test_peer.py's System)."""

    def __init__(self, package, chaos_broker=None, servings=1,
                 caller_peer=True, serving_peer=True, accept_handler=None,
                 caller_plan=None, serving_plan=None, retries=0,
                 remote_timeout=5.0, failure_budget=1):
        m = self.m = PACKAGES[package]
        self.engine = m["event"].EventEngine(m["event"].VirtualClock())
        self.broker = chaos_broker(m, self.engine) if chaos_broker \
            else m["memory"].MemoryBroker()
        self.runtimes = []
        P = m["pipeline"]
        self.classes = classes(P)
        self.registrar = m["registrar"](self.make_runtime("reg"))
        self.engine.clock.advance(2.1)
        self.settle()
        self.servings = []
        for index in range(servings):
            serve_rt = self.make_runtime(f"serve_rt{index + 1}")
            if serving_peer:
                serve_rt.enable_peer(accept_handler=accept_handler,
                                     fault_plan=serving_plan)
            serving = P.Pipeline(
                serve_rt, serving_definition(P),
                element_classes=self.classes,
                auto_create_streams=True, stream_lease_time=0)
            self.servings.append((serve_rt, serving))
        self.serve_rt, self.serving = self.servings[0]
        self.call_rt = self.make_runtime("call_rt")
        if caller_peer:
            self.call_rt.enable_peer(fault_plan=caller_plan)
        self.caller = P.Pipeline(
            self.call_rt, calling_definition(P),
            element_classes=self.classes,
            services_cache=m["cache"](self.call_rt),
            stream_lease_time=0, remote_timeout=remote_timeout,
            remote_retries=retries, remote_backoff=0.2,
            remote_backoff_max=1.0, retry_seed=3,
            stream_failure_budget=failure_budget)
        self.settle(100)
        self.done = []
        self.caller.add_frame_handler(self.done.append)
        self.caller.create_stream("s1", lease_time=0)

    def make_runtime(self, name):
        memory = self.m["memory"]

        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=self.broker,
                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                lwt_retain=lwt_retain, client_id=name)
        runtime = self.m["runtime"](
            name=name, engine=self.engine, namespace="test",
            process_id=name, transport_factory=factory).initialize()
        self.runtimes.append(runtime)
        return runtime

    def settle(self, steps=60):
        for _ in range(steps):
            self.engine.step()

    def settle_virtual(self, seconds):
        self.m["event"].settle_virtual(self.engine, seconds)

    def post(self, frames=1, steps=60):
        for _ in range(frames):
            self.caller.post("process_frame", "s1", {})
            self.settle(steps)

    def serving_in(self, index=0):
        return f"{self.servings[index][1].topic_path}/in"

    def peer_stats(self, runtime):
        return {key: runtime.peer.stats[key] for key in STATS}

    def outcome(self):
        return {
            "done": [(f.stream_id, f.frame_id,
                      np.asarray(f.swag.get("out")).tolist())
                     for f in self.done],
            "recovery": dict(self.caller.recovery_stats),
            "pending": len(self.caller._pending_remote),
            "caller": self.peer_stats(self.call_rt)
            if self.call_rt.peer else None,
            "serving": [self.peer_stats(rt) if rt.peer else None
                        for rt, _ in self.servings]}

    def teardown(self):
        for runtime in self.runtimes:
            if runtime.message is not None and runtime.message.connected():
                runtime.terminate()
            elif runtime.peer is not None:
                runtime.peer.close()


def run(package, body, **kwargs):
    system = System(package, **kwargs)
    try:
        return body(system)
    finally:
        system.teardown()


def chaos(seed, **rule):
    """A ChaosBroker factory whose plan holds one rule."""
    def make(m, engine):
        plan = m["chaos"].FaultPlan(seed=seed)
        getattr(plan, rule.pop("kind"))(**rule)
        return m["chaos"].ChaosBroker(plan, engine)
    return make


def test_data_plane_pins_and_broker_stays_flat():
    def body(system):
        pins = [system.caller.remote_elements_ready(),
                system.call_rt.peer.pinned(system.serving_in()),
                system.serve_rt.peer.pinned(f"{system.caller.topic_path}/in")]
        routed_before = system.broker.stats["routed"]
        system.post(frames=5)
        return pins, system.broker.stats["routed"] - routed_before, \
            system.outcome()
    pins, routed, outcome = both(lambda p: run(p, body))
    assert pins == [True, True, True] and routed == 0
    assert len(outcome["done"]) == 5
    assert outcome["done"][0][2] == [2.0 * i for i in range(8)]
    assert outcome["caller"]["sent"] == outcome["serving"][0]["sent"] == 5


def test_serving_without_peer_stays_on_broker():
    def body(system):
        pinned = system.call_rt.peer.pinned(system.serving_in())
        routed_before = system.broker.stats["routed"]
        system.post(frames=2)
        return pinned, system.broker.stats["routed"] > routed_before, \
            system.outcome()
    pinned, routed, outcome = both(
        lambda p: run(p, body, serving_peer=False))
    assert not pinned and routed and len(outcome["done"]) == 2
    assert outcome["caller"]["handshakes"] == 0


def test_handshake_refused_falls_back_to_broker():
    def body(system):
        pinned = system.call_rt.peer.pinned(system.serving_in())
        system.post(frames=3)
        return pinned, system.outcome()
    pinned, outcome = both(lambda p: run(
        p, body, accept_handler=lambda name, kind: "caller-not-allowed"))
    assert not pinned and len(outcome["done"]) == 3
    assert 1 <= outcome["serving"][0]["refused"] <= 2
    assert outcome["caller"]["sent"] == 0


def test_stale_nonce_from_restarted_incarnation_rejected():
    def body(system):
        host = system.call_rt.peer
        kind, address, _ = system.m["peer"].parse_endpoints(
            system.serve_rt.peer.tag.split("=", 1)[1])[0]
        host.release(system.serving_in())
        system.settle()
        host.negotiate(system.serving.topic_path, f"{kind}:{address}:dead",
                       pin_topics=[system.serving_in()],
                       reply_topics=[f"{system.caller.topic_path}/in"])
        system.settle(80)
        dropped = system.serving.topic_path not in host._negotiations
        pinned = host.pinned(system.serving_in())
        system.post(frames=1)
        return dropped, pinned, system.outcome()
    dropped, pinned, outcome = both(lambda p: run(p, body))
    assert dropped and not pinned and len(outcome["done"]) == 1
    assert outcome["serving"][0]["rejected_stale"] == 1


@pytest.mark.parametrize("match", ["peer_accept", "peer_open"])
def test_duplicated_handshake_messages_dedup(match):
    """A duplicated accept is counted and ignored; a duplicated open
    replays the same accept: one channel on each side either way."""
    def body(system):
        channels = (len(system.call_rt.peer._channels),
                    len(system.serve_rt.peer._channels))
        system.post(frames=2)
        return channels, system.outcome()
    channels, outcome = both(lambda p: run(p, body, chaos_broker=chaos(
        5, kind="duplicate", payload_match=match, count=1, copies=1)))
    assert channels == (1, 1) and len(outcome["done"]) == 2
    assert outcome["caller"]["dup_accepts"] == 1
    assert outcome["serving"][0]["accepted"] == 1


def test_dropped_accepts_leak_no_channels():
    def body(system):
        system.settle_virtual(10.0)
        host, serving = system.call_rt.peer, system.serve_rt.peer
        leaks = (host.pinned(system.serving_in()), len(host._offered),
                 len(host._pending), len(serving._channels),
                 len(serving._pins))
        system.post(frames=2)
        return leaks, system.outcome()
    leaks, outcome = both(lambda p: run(p, body, chaos_broker=chaos(
        8, kind="drop", payload_match="peer_accept")))
    assert leaks == (False, 0, 0, 0, 0) and len(outcome["done"]) == 2
    assert outcome["caller"]["expired_handshakes"] >= 1


def test_channel_death_mid_stream_redirects_and_renegotiates():
    def body(system):
        plan = system.call_rt.peer.fault_plan
        plan.drop(topic=system.serving_in(), count=1)
        system.caller.post("process_frame", "s1", {})
        system.settle(10)
        pending = len(system.caller._pending_remote)
        killed = system.call_rt.peer.kill_channels("mid-stream-kill")
        routed_before = system.broker.stats["routed"]
        system.settle_virtual(2.0)
        via_broker = system.broker.stats["routed"] > routed_before
        system.settle_virtual(1.0)
        repinned = system.call_rt.peer.pinned(system.serving_in())
        system.post(frames=1)
        return pending, killed, via_broker, repinned, system.outcome()

    def scenario(package):
        plan = PACKAGES[package]["chaos"].FaultPlan(seed=9)
        return run(package, body, caller_plan=plan, retries=2,
                   remote_timeout=1.0, failure_budget=2)
    pending, killed, via_broker, repinned, outcome = both(scenario)
    assert (pending, killed, via_broker, repinned) == (1, 1, True, True)
    assert len(outcome["done"]) == 2 and outcome["pending"] == 0
    assert outcome["recovery"]["retries"] >= 1
    assert outcome["caller"]["renegotiations"] >= 1


def test_failover_renegotiates_with_next_candidate():
    def body(system):
        first = system.call_rt.peer.pinned(system.serving_in(0))
        system.post(frames=1)
        system.serve_rt.message.crash()
        system.serve_rt.peer.kill_channels("process-kill")
        system.settle(80)
        system.caller.post("process_frame", "s1", {})
        system.settle_virtual(3.0)
        system.settle_virtual(1.0)
        return first, system.call_rt.peer.pinned(system.serving_in(1)), \
            system.outcome()
    first, second, outcome = both(lambda p: run(
        p, body, servings=2, retries=3, remote_timeout=1.0,
        failure_budget=3))
    assert first and second and len(outcome["done"]) == 2
    assert outcome["recovery"]["failovers"] >= 1


def test_chaos_peer_drops_recovered_by_retries():
    def body(system):
        plan = system.call_rt.peer.fault_plan
        plan.drop(topic=system.serving_in(), count=2)
        for _ in range(4):
            system.caller.post("process_frame", "s1", {})
            system.settle_virtual(3.0)
        return plan.stats["drop"], \
            system.call_rt.peer.pinned(system.serving_in()), \
            system.outcome()

    def scenario(package):
        plan = PACKAGES[package]["chaos"].FaultPlan(seed=13)
        return run(package, body, caller_plan=plan, retries=4,
                   remote_timeout=0.5, failure_budget=4)
    drops, pinned, outcome = both(scenario)
    assert drops == 2 and pinned and len(outcome["done"]) == 4
    assert outcome["recovery"]["retries"] >= 2


def test_peer_host_closes_with_runtime():
    def body(system):
        host = system.call_rt.peer
        token = host.token
        registered = token in system.m["peer"]._MEM_ENDPOINTS
        system.call_rt.terminate()
        return registered, host.closed, \
            token in system.m["peer"]._MEM_ENDPOINTS, \
            system.serve_rt.peer.pinned(f"{system.caller.topic_path}/in")
    assert both(lambda p: run(p, body)) == (True, True, False, False)


def test_second_pipeline_attaches_its_own_reply_pin():
    def body(system):
        P = system.m["pipeline"]
        second = P.Pipeline(
            system.call_rt, calling_definition(P), name="call2",
            element_classes=system.classes,
            services_cache=system.m["cache"](system.call_rt),
            stream_lease_time=0, remote_timeout=5.0)
        system.settle(120)
        try:
            attached = system.serve_rt.peer.pinned(f"{second.topic_path}/in")
            channels = len(system.call_rt.peer._channels)
            done = []
            second.add_frame_handler(done.append)
            second.create_stream("s2", lease_time=0)
            routed_before = system.broker.stats["routed"]
            for _ in range(3):
                second.post("process_frame", "s2", {})
                system.settle(60)
            return attached, channels, len(done), \
                system.broker.stats["routed"] - routed_before, \
                system.outcome()
        finally:
            second.stop()
    attached, channels, done, routed, outcome = both(lambda p: run(p, body))
    assert attached and channels == 1 and done == 3 and routed == 0
    assert outcome["caller"]["attach_requests"] == 1
    assert outcome["caller"]["attach_acks"] == 1
    assert outcome["serving"][0]["attach_pins"] == 1


def test_attach_to_dead_channel_is_refused_and_redial_repins_both():
    """An attach racing a channel death is refused and its pending mark
    clears; a channel death then re-dials and re-pins the reply topics of
    both pipelines that negotiated the service."""
    def body(system):
        P = system.m["pipeline"]
        host = system.call_rt.peer
        channel = host._pins[system.serving_in()]
        ghost = f"{system.caller.topic_path}/ghost"
        dead = system.serve_rt.peer._channels.pop(channel.channel_id)
        host._attached[(channel.channel_id, ghost)] = "pending"
        host._send_attach(system.serving.topic_path, channel, [ghost])
        system.settle(60)
        refused = (host.stats["attach_acks"],
                   (channel.channel_id, ghost) in host._attached,
                   len(host._attach_pending))
        system.serve_rt.peer._channels[channel.channel_id] = dead
        second = P.Pipeline(
            system.call_rt, calling_definition(P), name="call2b",
            element_classes=system.classes,
            services_cache=system.m["cache"](system.call_rt),
            stream_lease_time=0, remote_timeout=5.0)
        system.settle(120)
        try:
            host.kill_channels()
            system.settle(30)
            system.settle_virtual(5.0)
            pins = [host.pinned(system.serving_in()),
                    system.serve_rt.peer.pinned(
                        f"{system.caller.topic_path}/in"),
                    system.serve_rt.peer.pinned(f"{second.topic_path}/in")]
            return refused, pins, system.outcome()
        finally:
            second.stop()
    refused, pins, _ = both(lambda p: run(p, body))
    assert refused == (0, False, 0) and pins == [True, True, True]


def test_tcp_channel_round_trip_and_death():
    """A TCP channel negotiated through the control plane on a real
    clock (reader threads run in wall time): an envelope crosses the
    socket byte for byte, a kill on the far side unpins the near side,
    and the broker delivers the next one."""
    def scenario(package):
        m = PACKAGES[package]
        engine = m["event"].EventEngine()
        broker = m["memory"].MemoryBroker()
        runtimes = []

        def make_runtime(name):
            runtime = m["runtime"](
                name=name, engine=engine,
                transport_factory=lambda on_message, *_:
                    m["memory"].MemoryMessage(on_message=on_message,
                                              broker=broker)).initialize()
            runtimes.append(runtime)
            return runtime
        sender, receiver = make_runtime("tcp_a"), make_runtime("tcp_b")
        try:
            sender.enable_peer(kinds=())
            receiver.enable_peer(kinds=("tcp",))
            tcp_only = ",".join(
                desc for desc in receiver.peer.tag.split("=", 1)[1].split(",")
                if desc.startswith("tcp:"))
            topic = f"{receiver.topic_path}/7/in"
            got = []
            receiver.add_message_handler(
                lambda t, p: got.append(bytes(p)), topic)
            sender.peer.negotiate(f"{receiver.topic_path}/7", tcp_only,
                                  pin_topics=[topic], reply_topics=[])
            assert engine.run_until(lambda: sender.peer.pinned(topic),
                                    timeout=5.0)
            payload = m["wire"].encode_envelope(
                "ping", [{"x": np.arange(4, dtype=np.float32)}])
            sender.publish(topic, payload)
            assert engine.run_until(lambda: len(got) == 1, timeout=5.0)
            kinds = [c.kind for c in sender.peer._channels.values()]
            receiver.peer.kill_channels("test-kill")
            deadline = time.monotonic() + 5.0
            while sender.peer.pinned(topic) and \
                    time.monotonic() < deadline:
                engine.step()
                time.sleep(0.01)
            unpinned = not sender.peer.pinned(topic)
            sender.publish(topic, payload)
            assert engine.run_until(lambda: len(got) == 2, timeout=5.0)
            return (got[0] == payload, got[1] == payload, kinds, unpinned,
                    sender.peer.stats["sent"])
        finally:
            for runtime in runtimes:
                runtime.terminate()
    assert both(scenario) == (True, True, ["tcp"], True, 1)


def test_in_flight_counts_socket_frames_until_delivered():
    """in_flight() counts what a socket channel queued until the far
    end's engine holds it: a drive on a virtual clock waits for 0."""
    engine = TE.EventEngine(TE.VirtualClock())
    broker = TM.MemoryBroker()

    def make_runtime(name):
        return TProcessRuntime(
            name=name, engine=engine,
            transport_factory=lambda on_message, *_: TM.MemoryMessage(
                on_message=on_message, broker=broker)).initialize()
    sender, receiver = make_runtime("a"), make_runtime("b")
    try:
        hosts = (sender.enable_peer(kinds=()),
                 receiver.enable_peer(kinds=("tcp",)))
        tag = ",".join(d for d in receiver.peer.tag.split("=", 1)[1]
                       .split(",") if d.startswith("tcp:"))
        topic = f"{receiver.topic_path}/1/in"
        got = []
        receiver.add_message_handler(lambda t, p: got.append(p), topic)
        sender.peer.negotiate(f"{receiver.topic_path}/1", tag,
                              pin_topics=[topic], reply_topics=[])
        deadline = time.monotonic() + 5.0
        while not (sender.peer.pinned(topic) and receiver.peer._channels) \
                and time.monotonic() < deadline:
            engine.step()
            time.sleep(0.001)
        payload = TW.encode_envelope("x", [{"v": torch.arange(3.0)}])
        for _ in range(5):
            sender.publish(topic, payload)
        assert TPeer.in_flight(hosts) <= 5
        while TPeer.in_flight(hosts) and time.monotonic() < deadline:
            time.sleep(0.001)
        assert TPeer.in_flight(hosts) == 0
        while engine.step():
            pass
        assert len(got) == 5 and engine.clock.now() == 0.0
    finally:
        sender.terminate()
        receiver.terminate()


def test_parse_endpoints_matches_jax():
    tags = ["mem:tok:n1,uds:/tmp/a:b.sock:n2,tcp:127.0.0.1:4000:n3",
            "tcp:host:notaport:n,bogus,mem:x", "", "tcp:[::1]:9:n"]
    for tag in tags:
        assert TPeer.parse_endpoints(tag) == JPeer.parse_endpoints(tag)


# ---------------------------------------------------------------------------
# The remote transcription example over TCP peer channels
# ---------------------------------------------------------------------------

def in_flight(package, hosts) -> int:
    """Envelopes on the hosts' sockets not yet in an engine: the port's
    peer.in_flight, and the same count read from JAX's channels."""
    if package == "torch":
        return TPeer.in_flight(hosts)
    ends = {}
    for host in hosts:
        for channel in list(host._channels.values()):
            channel = getattr(channel, "inner", channel)
            if isinstance(channel, JPeer.SocketPeerChannel):
                ends.setdefault(channel.channel_id, []).append(channel)
    return sum(a.sent - a.shed - b.received + b.sent - b.shed - a.received
               for a, b in (pair for pair in ends.values()
                            if len(pair) == 2))


def tcp_only(host):
    """The port's host offers only what `kinds` names; the JAX host
    offers its in-process "mem" endpoint whatever `kinds` says (ROADMAP.md
    Queue 3 item 5), so it is taken out of JAX's advertisement here,
    before any service registers, as tests/test_peer.py's socket test
    does."""
    host._endpoints = [e for e in host._endpoints if not e.startswith("mem:")]
    return host


def run_remote_peer(package, weights, caller_rules=(), serving_rules=(),
                    retries=0, timeout=20.0):
    """The remote example on one package with both the caller's and the
    server's runtime on TCP peer channels (127.0.0.1).  `caller_rules`
    and `serving_rules` are (kind, kwargs) fault rules of two seeded
    FaultPlans on the channels' send sides ("{server}" and "{caller}" in a
    topic name the server's and the caller's in topics).  The drive
    advances the virtual clock only when no envelope is on a socket.
    Returns the caller's and the server's frames, the caller, the
    server, both peer hosts (caller's first), both plans and the
    messages the broker routed while the streams ran."""
    (event, memory, runtime_class, module, compute_class, registrar_class,
     cache_class, admission) = RS.PACKAGES[package]
    chaos = PACKAGES[package]["chaos"]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain,
                client_id=name)
        return runtime_class(name=name, engine=engine,
                             transport_factory=factory).initialize()

    def settle():
        while engine.step():
            pass

    registrar_class(runtime("reg"))
    engine.clock.advance(2.1)
    settle()
    plans = (chaos.FaultPlan(seed=0), chaos.FaultPlan(seed=1))
    serve_rt = runtime("serve")
    serve_host = tcp_only(serve_rt.enable_peer(
        kinds=("tcp",), fault_plan=plans[1] if serving_rules else None))
    compute = compute_class(serve_rt, "compute", **(
        {"device": "cpu"} if package == "torch" else {}))
    gate = admission.AdmissionGate(
        inflight_limit=64, metrics_labels={"pipeline": f"rp_{package}"})
    server = module.Pipeline(
        serve_rt, module.parse_pipeline_definition(
            RS.server_definition(weights[1])),
        stream_lease_time=0, auto_create_streams=True, admission=gate)
    asr = RS._element(server, "PE_WhisperASR")
    asr._setup()
    RS._to_f32(package, asr, weights)
    gate.watch_scheduler(
        compute.programs["whisper_asr.PE_WhisperASR"].scheduler)
    served = []
    server.add_frame_handler(served.append)
    call_rt = runtime("call")
    call_host = tcp_only(call_rt.enable_peer(
        kinds=("tcp",), fault_plan=plans[0] if caller_rules else None))
    definition = module.load_pipeline_definition(RS.REMOTE)
    definition.parameters["PE_LogMel.device"] = "cpu"
    caller = module.Pipeline(
        call_rt, definition, services_cache=cache_class(call_rt),
        stream_lease_time=0, remote_timeout=timeout,
        remote_retries=retries, retry_seed=3)
    topics = {"server": f"{server.topic_path}/in", "caller": caller.topic_in}
    for plan, rules in zip(plans, (caller_rules, serving_rules)):
        for kind, kwargs in rules:
            getattr(plan, kind)(**{**kwargs, "topic": kwargs["topic"].format(
                **topics)})
    hosts = (call_host, serve_host)
    deadline = time.monotonic() + 10.0
    while not (call_host.pinned(topics["server"]) and
               serve_host.pinned(topics["caller"])) and \
            time.monotonic() < deadline:
        settle()
        time.sleep(0.001)
    assert caller.remote_elements_ready()
    assert call_host.pinned(topics["server"])
    assert serve_host.pinned(topics["caller"])
    done = []
    caller.add_frame_handler(done.append)
    routed_before = broker.stats["routed"]
    RS._streams(caller)
    while len(done) < RS.STREAMS * RS.FRAMES and engine.clock.now() < 60.0:
        settle()
        while in_flight(package, hosts) and time.monotonic() < deadline + 60:
            time.sleep(0.0005)
        settle()
        engine.clock.advance(0.01)
    routed = broker.stats["routed"] - routed_before
    channels = [getattr(channel, "inner", channel) for host in hosts
                for channel in host._channels.values()]
    for pipeline in (caller, server):
        for stream_id in list(pipeline.streams):
            pipeline.destroy_stream(stream_id)
    for rt in (call_rt, serve_rt):
        rt.terminate()
    return done, served, caller, server, hosts, plans, routed, channels


def test_remote_example_over_tcp_peer_channels(weights):
    """Every request and reply envelope of the hop crosses a TCP socket
    (the broker routes no data-plane envelope), and the tokens equal
    JAX's and the broker run's for every (stream, frame)."""
    port = run_remote_peer("torch", weights)
    reference = run_remote_peer("jax", weights)
    broker_run = RS.run_remote("torch", weights)
    RS.check_remote(port[:2] + (None,) + port[2:4],
                    reference[:2] + (None,) + reference[2:4], np.float32)
    tokens = RS._tokens(port[0])
    assert tokens.keys() == RS._tokens(broker_run[0]).keys()
    for key, value in RS._tokens(broker_run[0]).items():
        np.testing.assert_array_equal(tokens[key], value)
    counts = []
    for run in (port, reference):
        call_host, serve_host = run[4]
        # requests one way, replies the other, all on the channel
        assert call_host.stats["sent"] == serve_host.stats["received"] > 0
        assert serve_host.stats["sent"] == call_host.stats["received"] > 0
        assert call_host.stats["fallback"] == serve_host.stats["fallback"] \
            == 0
        assert {channel.kind for channel in run[7]} == {"tcp"}
        counts.append((call_host.stats["sent"], serve_host.stats["sent"],
                       run[6]))
    assert counts[0] == counts[1]
    # one handshake, one channel (an end on each side) on the port; the
    # JAX host dials a second channel when discovery fires again while
    # its first socket dial is connecting (ROADMAP.md Queue 3 item 6)
    assert port[4][0].stats["handshakes"] == 1 and len(port[7]) == 2
    assert reference[4][0].stats["handshakes"] >= 1
