"""The port's MQTT transport held against the JAX package, over the
loopback paho surface (no broker, no paho): the scenarios of
tests/test_mqtt.py — text and binary round trips, the LWT on an
ungraceful drop and not on a graceful one, reconnect with re-subscribe,
publishes buffered while down and flushed in order, the seeded reconnect
backoff, a rejected CONNACK, disconnect ending the reconnects, an LWT
change cycling the connection, and the registrar election with an actor
RPC and an LWT purge over MQTT.  Each scenario runs on both packages and
must give the same outcome."""

import sys
import time

import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu.actor import Actor as JActor
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu.transport import mqtt as JMQTT
from aiko_services_tpu.transport import paho_loopback as JLoop
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch.actor import Actor as TActor
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.transport import mqtt as TMQTT
from aiko_services_tpu_torch.transport import paho_loopback as TLoop

PACKAGES = {"jax": (JMQTT, JLoop), "torch": (TMQTT, TLoop)}


def both(scenario):
    port, reference = scenario("torch"), scenario("jax")
    assert port == reference
    return port


def wait_for(predicate, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return False


class Loop:
    """One package's loopback broker and MQTTMessage clients on it."""

    def __init__(self, package):
        self.mqtt, self.loop = PACKAGES[package]
        self.broker = self.loop.LoopbackBroker()

    def client(self, topics=(), factory=None, **kwargs):
        seen, fake = [], {}

        def make():
            fake["client"] = (factory or self.loop.LoopbackPaho)(self.broker)
            return fake["client"]
        message = self.mqtt.MQTTMessage(
            on_message=lambda t, p: seen.append((t, p)),
            subscriptions=list(topics), client_factory=make,
            backoff_min=0.02, backoff_max=0.1, **kwargs)
        message.connect(timeout=1.0)
        return message, fake["client"], seen


def test_paho_is_never_imported_and_mqtt_is_unavailable_without_it():
    assert "paho" not in sys.modules
    assert TMQTT.MQTT_AVAILABLE is False
    with pytest.raises(ImportError, match="paho-mqtt is not installed"):
        TMQTT.MQTTMessage()


def test_round_trips_and_the_lwt_on_an_ungraceful_drop():
    def scenario(package):
        loop = Loop(package)
        _, _, seen = loop.client(["ns/+/in", "bin/#", "ns/+/state"])
        sender, _, _ = loop.client()
        sender.publish("ns/host/in", "(hello)")
        sender.publish("bin/tensor", b"\xff\xfe\x00raw")
        victim, _, _ = loop.client(lwt_topic="ns/victim/state",
                                   lwt_payload="(absent)")
        victim.disconnect()                 # graceful: no LWT
        graceful = list(seen)
        _, victim_client, _ = loop.client(lwt_topic="ns/victim/state",
                                          lwt_payload="(absent)")
        victim_client.drop()
        return graceful, seen
    graceful, seen = both(scenario)
    assert graceful == [("ns/host/in", "(hello)"),
                        ("bin/tensor", b"\xff\xfe\x00raw")]
    assert seen[-1] == ("ns/victim/state", "(absent)")


def test_reconnect_resubscribes_and_flushes_buffered_publishes():
    def scenario(package):
        loop = Loop(package)
        message, client, seen = loop.client(["a/b", "q/#"])
        client.drop()
        down = message.connected()
        assert wait_for(message.connected)
        resubscribed = "a/b" in client.subscriptions
        sender, sender_client, _ = loop.client()
        sender.publish("a/b", "back")
        loop.broker.down = True
        sender_client.drop()
        for i in range(3):
            sender.publish(f"q/{i}", f"m{i}")
        buffered = sender.stats["buffered"]
        loop.broker.down = False
        assert wait_for(sender.connected)
        assert wait_for(lambda: len(seen) == 4)
        for client in (message, sender):
            client.disconnect()
        return down, resubscribed, buffered, seen
    down, resubscribed, buffered, seen = both(scenario)
    assert not down and resubscribed and buffered == 3
    assert [p for _, p in seen] == ["back", "m0", "m1", "m2"]


def test_backoff_is_seeded_doubles_and_resets():
    def delays(package, seed):
        loop = Loop(package)
        message, client, _ = loop.client(jitter_seed=seed,
                                         backoff_jitter=0.5)
        loop.broker.down = True
        client.drop()
        sequence = []
        for _ in range(3):
            timer = message._reconnect_timer
            sequence.append(timer.interval)
            timer.cancel()
            with message._lock:
                message._reconnect_timer = None
            message._attempt_reconnect()
        attempts = message._attempts
        loop.broker.down = False
        message._reconnect_timer.cancel()
        with message._lock:
            message._reconnect_timer = None
        message._attempt_reconnect()
        connected = message.connected()
        message.disconnect()
        return sequence, attempts, message._attempts, connected

    first = both(lambda package: delays(package, 9))
    assert first != delays("torch", 10)
    sequence, attempts, reset, connected = first
    assert attempts == 4 and reset == 0 and connected
    for attempt, delay in enumerate(sequence):
        low = min(0.02 * 2 ** attempt, 0.1)
        assert low <= delay <= low * 1.5 + 1e-9


def test_rejected_connack_broker_down_and_disconnect():
    def scenario(package):
        loop = Loop(package)

        class Rejecting(loop.loop.LoopbackPaho):
            def connect(self, host, port):
                self.connect_attempts += 1
                if self.on_connect:
                    self.on_connect(self, None, None, 5)
        rejected, _, _ = loop.client(factory=Rejecting)
        rejected.publish("x", "y")
        outcome = [rejected.connected(), "rejected" in
                   rejected.stats["last_error"], rejected.stats["buffered"]]
        rejected.disconnect()
        loop.broker.down = True
        late, _, _ = loop.client()
        outcome.append(late.connected())
        loop.broker.down = False
        outcome.append(wait_for(late.connected))
        loop.broker.down = True
        message, client, _ = loop.client()
        client.drop()
        message.disconnect()
        attempts = client.connect_attempts
        time.sleep(0.15)
        outcome.append(client.connect_attempts == attempts)
        late.disconnect()
        return outcome
    assert both(scenario) == [False, True, 1, False, True, True]


def test_lwt_change_cycles_the_connection():
    def scenario(package):
        loop = Loop(package)
        _, _, seen = loop.client(["ns/+/state"])
        message, client, _ = loop.client(lwt_topic="ns/me/state",
                                         lwt_payload="(absent)")
        message.set_last_will_and_testament("ns/me/state", "(gone v2)")
        assert wait_for(message.connected)
        will = client.will
        client.drop()
        return will, seen
    will, seen = both(scenario)
    assert will == ("ns/me/state", "(gone v2)", False)
    assert seen == [("ns/me/state", "(gone v2)")]


def test_registrar_election_rpc_and_lwt_purge_over_mqtt():
    """The control plane over MQTT on a real clock: election, an actor
    RPC, and the registrar purging a host whose LWT fires."""
    def scenario(package):
        event, runtime_class, registrar_class, actor_class = {
            "jax": (JE, JProcessRuntime, JRegistrar, JActor),
            "torch": (TE, TProcessRuntime, TRegistrar, TActor)}[package]
        loop = Loop(package)
        engine = event.EventEngine()

        def runtime(name):
            def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
                return loop.mqtt.MQTTMessage(
                    on_message=on_message, lwt_topic=lwt_topic,
                    lwt_payload=lwt_payload, lwt_retain=lwt_retain,
                    client_factory=lambda: loop.loop.LoopbackPaho(
                        loop.broker),
                    backoff_min=0.02, backoff_max=0.1)
            return runtime_class(name=name, engine=engine,
                                 transport_factory=factory).initialize()

        class Echo(actor_class):
            def __init__(self, runtime, name):
                super().__init__(runtime, name, "echo")
                self.heard = []

            def echo(self, text):
                self.heard.append(str(text))

        r1, r2 = runtime("host_a"), runtime("host_b")
        registrar = registrar_class(r1)
        primary = engine.run_until(lambda: registrar.is_primary,
                                   timeout=6.0)

        def registered():
            return any(f.name == "echo" for f in registrar.services)
        echo = Echo(r2, "echo")
        found = engine.run_until(registered, timeout=6.0)
        r1.publish(f"{echo.topic_path}/in", "(echo over-mqtt)")
        heard = engine.run_until(lambda: echo.heard == ["over-mqtt"],
                                 timeout=6.0)
        for client in loop.broker.clients:
            if client.will and client.will[0] == r2.topic_state:
                client.drop()
        purged = engine.run_until(lambda: not registered(), timeout=6.0)
        r1.terminate()
        return primary, found, heard, purged, r2.transport_name
    assert both(scenario) == (True, True, True, True, "mqtt")
