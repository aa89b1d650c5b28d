"""The port's host plane (event engine, timer wheel, s-expressions,
in-memory broker, actors, EC shares, process runtime) held against the
JAX package's: the same seeded scripts run on both and must give the
same handler calls, payloads and deliveries.  Nothing here touches a
device."""

import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu.actor import Actor as JActor
from aiko_services_tpu.ops import batching as j_batching
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.service import ServiceFilter as JServiceFilter
from aiko_services_tpu.share import ECConsumer as JECConsumer
from aiko_services_tpu.share import ServicesCache as JServicesCache
from aiko_services_tpu.state.wheel import TimerWheel as JTimerWheel
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu.transport.message import topic_matches as j_matches
from aiko_services_tpu.utils import sexpr as JS
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch.actor import Actor as TActor
from aiko_services_tpu_torch.actor import get_remote_proxy
from aiko_services_tpu_torch.compute import ComputeRuntime
from aiko_services_tpu_torch.lease import Lease
from aiko_services_tpu_torch.observe import tracing
from aiko_services_tpu_torch.ops import batching as t_batching
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.service import ServiceFilter as TServiceFilter
from aiko_services_tpu_torch.share import ECConsumer as TECConsumer
from aiko_services_tpu_torch.share import ServicesCache as TServicesCache
from aiko_services_tpu_torch.state.wheel import TimerWheel as TTimerWheel
from aiko_services_tpu_torch.transport import memory as TM
from aiko_services_tpu_torch.transport.message import \
    topic_matches as t_matches
from aiko_services_tpu_torch.utils import sexpr as TS

PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JActor, JECConsumer),
    "torch": (TE, TM, TProcessRuntime, TActor, TECConsumer),
}


def _system(package):
    """One engine on a virtual clock, one broker, and a runtime factory
    of the given package (the port never gets a JAX object)."""
    event, memory, runtime_class, _, _ = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def make_runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        return runtime_class(name=name, engine=engine, namespace="test",
                             process_id=name,
                             transport_factory=factory).initialize()
    return engine, broker, make_runtime


# -- event engine -------------------------------------------------------------

def _engine_script(seed):
    """A seeded script of engine operations at virtual times."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(40):
        at = round(float(rng.uniform(0.0, 1.5)), 3)
        kind = rng.choice(["timer", "oneshot", "mailbox", "queue",
                           "cancel", "flatout"],
                          p=[0.15, 0.3, 0.25, 0.15, 0.1, 0.05])
        ops.append((at, step, str(kind), float(rng.uniform(0.01, 0.4)),
                    int(rng.integers(0, 3))))
    return sorted(ops)


def _run_engine_script(package, seed):
    event = PACKAGES[package][0]
    engine = event.EventEngine(event.VirtualClock())
    log, handles = [], []
    for name in ("m0", "m1", "m2"):
        def on_mail(mailbox, item, _put_time, _engine=engine):
            log.append(("mail", mailbox, item))
            if item.endswith("!"):
                # a handler posting back waits for the next step
                _engine.mailbox_put("m2", item[:-1] + "?")
        engine.add_mailbox_handler(on_mail, name)
    engine.add_queue_handler(
        lambda queue, item, _t: log.append(("queue", queue, item)), "q")
    flatout_calls = []

    def flatout():
        flatout_calls.append(engine.clock.now())
        if len(flatout_calls) == 3:
            engine.remove_flatout_handler(flatout)
            log.append(("flatout", len(flatout_calls)))

    script = _engine_script(seed)
    cursor = 0
    while cursor < len(script) or engine.clock.now() < 2.0:
        now = engine.clock.now()
        while cursor < len(script) and script[cursor][0] <= now:
            _, step, kind, delay, lane = script[cursor]
            cursor += 1
            tag = f"{kind}{step}"
            if kind == "timer":
                handles.append(engine.add_timer_handler(
                    lambda t=tag: log.append(("timer", t, round(
                        engine.clock.now(), 2))), delay,
                    immediate=bool(lane == 0)))
            elif kind == "oneshot":
                handles.append(engine.add_oneshot_handler(
                    lambda t=tag: log.append(("oneshot", t, round(
                        engine.clock.now(), 2))), delay))
            elif kind == "mailbox":
                engine.mailbox_put(f"m{lane}",
                                   tag + ("!" if lane == 1 else ""))
            elif kind == "queue":
                engine.queue_put("q", tag)
            elif kind == "cancel" and handles:
                engine.remove_timer_handler(handles.pop(lane % len(handles)))
            elif kind == "flatout" and not flatout_calls:
                engine.add_flatout_handler(flatout)
        while engine.step():
            pass
        engine.clock.advance(0.01)
    return log, len(engine.live_timer_handlers())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_scripts_call_handlers_in_the_same_order(seed):
    jax_log, jax_live = _run_engine_script("jax", seed)
    port_log, port_live = _run_engine_script("torch", seed)
    assert len(port_log) > 20
    assert port_log == jax_log and port_live == jax_live


@pytest.mark.parametrize("seed", [0, 1])
def test_timer_wheel_expires_alike(seed):
    rng = np.random.default_rng(seed)
    wheels = (JTimerWheel(0.0, tick=0.01), TTimerWheel(0.0, tick=0.01))
    fired = ([], [])
    now = 0.0
    for _ in range(300):
        op = rng.integers(0, 3)
        due = now + float(rng.exponential(3.0))
        handle = int(rng.integers(1, 200))
        for wheel, out in zip(wheels, fired):
            if op == 0:
                wheel.schedule(due, f"p{handle}")
            elif op == 1:
                out.append(("cancel", wheel.cancel(handle)))
            else:
                out.extend((e.handle, e.payload) for e in wheel.advance(now))
        now += float(rng.uniform(0.0, 0.2))
    for wheel, out in zip(wheels, fired):
        out.extend((e.handle, e.payload) for e in wheel.advance(now + 1e4))
        out.append(("left", len(wheel), wheel.next_due()))
    assert fired[0] == fired[1]


def test_lease_expires_extends_and_cancels_on_the_engine_clock():
    engine = TE.EventEngine(TE.VirtualClock())
    expired, extended = [], []
    lease = Lease(engine, 1.0, "a", lease_expired_handler=expired.append)
    auto = Lease(engine, 1.0, "b", automatic_extend=True,
                 lease_extend_handler=lambda t, i: extended.append(i))
    TE.settle_virtual(engine, 0.9, tick=0.05)
    lease.extend()                        # 1 s from now
    TE.settle_virtual(engine, 0.9, tick=0.05)
    assert expired == []
    TE.settle_virtual(engine, 0.3, tick=0.05)
    assert expired == ["a"] and extended == ["b", "b"]
    auto.cancel()
    assert engine.live_timer_handlers() == []


# -- s-expressions -------------------------------------------------------------

def _corpus(seed, count=60):
    rng = np.random.default_rng(seed)
    atoms = ["a", "pele", "12", "-3.5", "", "two words", "(paren", "x)",
             "key:", "7:raw", "a:b", "tab\there", "ünï", "true", "1e-9"]

    def value(depth):
        pick = rng.integers(0, 4 if depth < 3 else 1)
        if pick == 0:
            return atoms[rng.integers(0, len(atoms))]
        if pick == 1:
            return [value(depth + 1) for _ in range(rng.integers(0, 4))]
        if pick == 2:
            return {f"k{i}": value(depth + 1)
                    for i in range(rng.integers(1, 4))}
        return int(rng.integers(-50, 50))
    return [value(0) for _ in range(count)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sexpr_round_trips_agree(seed):
    for obj in _corpus(seed):
        text = TS.generate_sexpr(obj)
        assert text == JS.generate_sexpr(obj)
        assert TS.parse_sexpr(text) == JS.parse_sexpr(text)
        payload = TS.generate("command", [obj, "tail"])
        assert payload == JS.generate("command", [obj, "tail"])
        assert TS.parse(payload) == JS.parse(payload)


@pytest.mark.parametrize("payload", [
    "(a (b c)", "a) b", "(a) (b)", "(9:short)", "", "bare", "(k: v j: (1 2))",
    "(k: v odd)", "((nested))", "(x: 3:a b y: 0:)"])
def test_sexpr_parse_accepts_and_rejects_alike(payload):
    def outcome(module):
        try:
            return "ok", module.parse_sexpr(payload), module.parse(payload)
        except module.ParseError as exc:
            return "error", type(exc).__name__
    assert outcome(TS) == outcome(JS)


def test_scalar_parsers_agree():
    for value in ["3", "-2", "2.5", "x", None, "1e3", True, " 7 "]:
        for name in ("parse_int", "parse_float", "parse_number",
                     "parse_bool"):
            assert getattr(TS, name)(value) == getattr(JS, name)(value)
    assert TS.list_to_dict(["a", "1", "b", "2"]) == \
        JS.list_to_dict(["a", "1", "b", "2"])
    assert TS.dict_to_list({"a": 1}) == JS.dict_to_list({"a": 1})


# -- in-memory broker -----------------------------------------------------------

def test_topic_matching_agrees():
    patterns = ["a/b/c", "a/+/c", "a/#", "#", "+/+", "a/+", "+/b/#",
                "a/b", "a/b/c/d", "+"]
    topics = ["a/b/c", "a/x/c", "a", "a/b", "b/b/c/d", "a/b/c/d", "x",
              "a//c"]
    for pattern in patterns:
        for topic in topics:
            assert t_matches(pattern, topic) == j_matches(pattern, topic)


def _broker_script(package):
    memory = PACKAGES[package][1]
    broker = memory.MemoryBroker()
    log = []

    def client(name, subscriptions=(), will=None):
        message = memory.MemoryMessage(
            on_message=lambda t, p: log.append((name, t, p)),
            subscriptions=subscriptions, broker=broker,
            lwt_topic=will, lwt_payload="(absent)" if will else None,
            lwt_retain=True)
        message.connect()
        return message

    publisher = client("pub", will="ns/pub/state")
    publisher.publish("ns/pub/state", "(present)", retain=True)
    publisher.publish("ns/config", "(v 1)", retain=True)
    watcher = client("watch", ["ns/+/state", "ns/#"])
    watcher.publish("ns/pub/data", "(frame 1)")
    exact = client("exact", ["ns/config"])
    exact.subscribe("ns/pub/data")
    publisher.publish("ns/pub/data", "(frame 2)")
    publisher.publish("ns/config", "", retain=True)       # clears it
    late = client("late", ["ns/config", "ns/pub/state"])
    exact.unsubscribe("ns/pub/data")
    publisher.crash()                      # fires the last will
    late.disconnect()
    late.publish("ns/pub/data", "(frame 3)")
    return log, broker.retained("ns/pub/state"), broker.retained("ns/config")


def test_broker_routes_retains_and_fires_wills_alike():
    port = _broker_script("torch")
    assert port == _broker_script("jax")
    log, state, config = port
    assert state == "(absent)" and config is None
    assert ("watch", "ns/pub/state", "(absent)") in log


# -- actors, shares and the process runtime ------------------------------------

class _Greeter:
    """Protocol class: its public methods become proxy calls."""

    def greet(self, name, count):
        pass


def _actor_script(package):
    engine, _, make_runtime = _system(package)
    actor_class = PACKAGES[package][3]
    calls = []

    class Greeter(actor_class):
        def greet(self, name, count):
            calls.append(("greet", name, count))

        def control_ping(self):
            calls.append(("control_ping",))

    host = make_runtime("host")
    greeter = Greeter(host, "greeter")
    greeter.post("greet", "local", 1)
    greeter.post("control_ping")          # control drains first
    greeter.post("_private")              # never dispatched
    host.publish(greeter.topic_in, "(greet Pele 2)")
    while engine.step():
        pass
    return calls, greeter


def test_actor_posts_and_messages_become_method_calls():
    port_calls, greeter = _actor_script("torch")
    assert port_calls == _actor_script("jax")[0]
    assert port_calls[0] == ("control_ping",)
    # a remote proxy publishes the call, with the ambient trace context
    # riding along: on the binary-capable memory transport an array
    # argument ships in a binary wire envelope (trace in its header); on
    # a text-only transport the call is an S-expression whose array is
    # its nested list's text and whose trace is a trailing marker, as
    # the JAX package's text path sends it
    engine = greeter.runtime.event

    class TextOnlyMessage(TM.MemoryMessage):
        BINARY = False

    seen = []
    greeter.greet = lambda name, count: seen.append(
        (name, count, tracing.current_trace()))
    for message_class in (TM.MemoryMessage, TextOnlyMessage):
        caller = TProcessRuntime(
            name="caller", engine=engine,
            transport_factory=lambda *args, cls=message_class: cls(
                on_message=args[0], broker=greeter.runtime.message.broker))
        caller.initialize()
        proxy = get_remote_proxy(caller, greeter.topic_in, _Greeter)
        context = tracing.new_trace(deadline=engine.clock.now() + 5.0)
        with tracing.activate(context):
            proxy.greet("Kai", np.arange(3))
        while engine.step():
            pass
        (name, count, trace), = seen[-1:]
        assert trace.trace_id == context.trace_id
        assert trace.remaining(engine.clock.now()) == pytest.approx(5.0)
        caller.terminate()
    binary, text = seen
    assert binary[0] == "Kai" and binary[1].tolist() == [0, 1, 2]
    assert not binary[1].flags.writeable          # a view of the payload
    assert text[:2] == ("Kai", "(0 1 2)")


def _share_script(package):
    engine, _, make_runtime = _system(package)
    _, _, _, actor_class, consumer_class = PACKAGES[package]
    producer = actor_class(make_runtime("producer"), "producer",
                           share={"level": 1})
    cache, events = {}, []
    consumer = consumer_class(make_runtime("consumer"), cache,
                              producer.topic_control)
    consumer.add_handler(lambda *event: events.append(event))
    while engine.step():
        pass
    producer.ec_producer.update("level", 2)
    producer.ec_producer.update("flag", True)
    producer.ec_producer.update("stats", {"mean": 0.25, "label": "a b"})
    producer.ec_producer.update("stats.count", 7)
    producer.ec_producer.remove("running")
    while engine.step():
        pass
    return cache, events, consumer.synchronized


def test_ec_producer_updates_reach_the_consumer_alike():
    port = _share_script("torch")
    assert port == _share_script("jax")
    cache, _, synchronized = port
    assert synchronized and "running" not in cache
    assert cache["level"] == 2 and cache["flag"] is True
    # a branch update crosses whole, with its scalars folded back
    assert cache["stats"] == {"mean": 0.25, "label": "a b"}
    assert cache["stats.count"] == 7


_RECORDS = [
    ["test/h/p1/1", "alpha", "test/compute:0", "memory", "ann", ["k=v"]],
    ["test/h/p1/2", "beta", "test/pipeline:0", "memory", "ann", []],
    ["test/h/p2/1", "gamma", "test/compute:0", "memory", "bob", ["x=1"]],
]


def _services_cache_script(package):
    """A stand-in registrar answers the cache's share request with a
    snapshot, then sends live add/remove events and finally goes absent;
    returns what the cache's handlers saw and what it holds."""
    engine, _, make_runtime = _system(package)
    cache_class, filter_class = {
        "jax": (JServicesCache, JServiceFilter),
        "torch": (TServicesCache, TServiceFilter)}[package]
    registrar, client = make_runtime("registrar"), make_runtime("client")
    requests = []

    def registrar_in(_topic, payload):
        command, params = JS.parse(payload)
        requests.append(command)
        if command == "share":
            registrar.publish(params[0], JS.generate("item_count", ["2"]))
            for record in _RECORDS[:2]:
                registrar.publish(params[0], JS.generate("add", [record]))

    registrar.add_message_handler(registrar_in,
                                  f"{registrar.topic_path}/in")
    cache = cache_class(client)
    seen = []
    cache.add_handler(lambda command, fields:
                      seen.append((command, fields.to_record())),
                      filter_class(protocol="test/compute*"))
    registrar.publish(client.topic_registrar_boot,
                      JS.generate("primary", ["found", registrar.topic_path,
                                              "0", "0"]), retain=True)
    while engine.step():
        pass
    synchronized = cache.synchronized
    out = f"{registrar.topic_path}/out"
    registrar.publish(out, JS.generate("add", [_RECORDS[2]]))
    registrar.publish(out, JS.generate("remove", [_RECORDS[0][0]]))
    registrar.publish(out, JS.generate("remove", ["test/h/p9/1"]))
    while engine.step():
        pass
    held = sorted(f.to_record() for f in cache.get_services())
    history = [f.to_record() for f in cache.history]
    registrar.publish(client.topic_registrar_boot,
                      JS.generate("primary", ["absent"]), retain=True)
    while engine.step():
        pass
    result = (requests, seen, held, history, synchronized,
              cache.synchronized)
    cache.terminate()
    return result


def test_services_cache_replicates_the_registrar_table_alike():
    port = _services_cache_script("torch")
    assert port == _services_cache_script("jax")
    requests, seen, held, history, synchronized, after_absent = port
    assert requests == ["share"] and synchronized and not after_absent
    # the filter passes the compute services only: snapshot, live, removal
    assert seen == [("add", _RECORDS[0]), ("add", _RECORDS[2]),
                    ("remove", _RECORDS[0])]
    assert held == sorted(_RECORDS[1:]) and history == [_RECORDS[0]]


def test_service_by_name_finds_the_compute_runtime():
    engine, _, make_runtime = _system("torch")
    runtime = make_runtime("host")
    compute = ComputeRuntime(runtime, "compute", device="cpu")
    assert runtime.service_by_name("compute") is compute
    assert runtime.service_by_name("absent") is None
    share = compute.ec_producer.share
    assert share["platform"] == "cpu" and share["device_count"] == 1
    assert compute.ec_producer.get("device.0.mem_pct") == -1
    assert str(compute.protocol).endswith("/compute:0")
    compute.stop()
    assert runtime.service_by_name("compute") is None
    assert engine.live_timer_handlers() == []
    runtime.terminate()


# -- batch former: completion deadlines ---------------------------------------

def _scheduler_script(package, seed):
    """Seeded submits with and without completion deadlines, measured
    service times fed back, and clock advances, on one package's
    BatchingScheduler.  Returns every dispatch (bucket, stream ids, time)
    and the deadline-driven dispatch count."""
    batching = {"jax": j_batching, "torch": t_batching}[package]
    rng = np.random.default_rng(seed)
    now = [0.0]
    dispatches = []

    def process_batch(bucket, items):
        dispatches.append((bucket, [i.stream_id for i in items], now[0]))
        return [None] * len(items)

    scheduler = batching.BatchingScheduler(
        process_batch, batching.ShapeBuckets([8, 16, 32]), max_batch=4,
        max_wait=0.1, clock=lambda: now[0])
    for step in range(120):
        now[0] += float(rng.uniform(0.0, 0.03))
        for _ in range(int(rng.integers(0, 3))):
            deadline = None if rng.random() < 0.4 else \
                now[0] + float(rng.uniform(0.01, 0.2))
            scheduler.submit(f"s{step}", None, int(rng.integers(1, 33)),
                             lambda *_: None, deadline=deadline)
        if rng.random() < 0.3:
            scheduler.observe_service_time(
                int(rng.choice([8, 16, 32])), float(rng.uniform(0.01, 0.08)))
        scheduler.drain()
    scheduler.drain(force=True)
    return dispatches, scheduler.stats["deadline_dispatches"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_former_dispatches_alike_under_deadlines(seed):
    port = _scheduler_script("torch", seed)
    assert port == _scheduler_script("jax", seed)
    dispatches, deadline_dispatches = port
    # the script exercises early dispatch of partial batches
    assert deadline_dispatches > 0
    assert any(len(ids) < 4 for _, ids, _ in dispatches)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_partial_batch_dispatches_when_its_deadline_is_at_risk(package):
    batching = {"jax": j_batching, "torch": t_batching}[package]
    now, dispatched = [0.0], []
    scheduler = batching.BatchingScheduler(
        lambda bucket, items: dispatched.append(now[0]) or [1] * len(items),
        batching.ShapeBuckets([16]), max_batch=4, max_wait=1.0,
        clock=lambda: now[0])
    scheduler.submit("a", None, 10, lambda *_: None, deadline=0.05)
    scheduler.drain()
    assert dispatched == []               # no service estimate yet
    scheduler.observe_service_time(16, 0.03)
    now[0] = 0.01
    scheduler.drain()
    assert dispatched == []               # slack 0.04 > 0.03
    now[0] = 0.025
    scheduler.drain()
    # slack 0.025 <= 0.03: one item dispatches long before max_wait
    assert dispatched == [0.025]
    assert scheduler.stats["deadline_dispatches"] == 1
    assert scheduler.mean_batch_size() == 1.0
