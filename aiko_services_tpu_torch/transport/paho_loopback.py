# Loopback paho surface: an in-process "MQTT broker" and the paho-v2
# client face MQTTMessage drives, with no network and no daemon.
#
# The port's own copy of aiko_services_tpu/transport/paho_loopback.py:
# the full MQTTMessage code path — connect callbacks, subscriptions,
# retained state, LWT on ungraceful drops, reconnect backoff — runs
# against a deterministic broker this process owns, with no paho
# installed.  Production code never imports it.

from __future__ import annotations

from .message import topic_matches

__all__ = ["LoopbackBroker", "LoopbackPaho"]


class LoopbackBroker:
    """Minimal broker shared by LoopbackPaho clients: routes published
    messages to subscribed clients, fires LWT on ungraceful drops."""

    def __init__(self):
        self.clients = []
        self.down = False          # simulates broker/network outage
        self.retained = {}

    def route(self, topic, payload, retain=False):
        if retain:                 # MQTT: empty retained payload clears
            if payload in ("", b""):
                self.retained.pop(topic, None)
            else:
                self.retained[topic] = payload
        for client in list(self.clients):
            if not client.connected_to_broker:
                continue
            for pattern in list(client.subscriptions):
                if topic_matches(pattern, topic):
                    client.deliver(topic, payload)
                    break

    def send_retained(self, client, pattern):
        for topic, payload in list(self.retained.items()):
            if topic_matches(pattern, topic):
                client.deliver(topic, payload)


class _PublishInfo:
    def wait_for_publish(self, timeout=None):
        return True


class LoopbackPaho:
    """The paho v2 client surface MQTTMessage uses."""

    def __init__(self, broker: LoopbackBroker):
        self.broker = broker
        self.subscriptions = set()
        self.connected_to_broker = False
        self.will = None
        self.on_connect = None
        self.on_disconnect = None
        self.on_message = None
        self.connect_attempts = 0
        broker.clients.append(self)

    # -- connection --------------------------------------------------------
    def connect(self, host, port):
        self.connect_attempts += 1
        if self.broker.down:
            raise ConnectionRefusedError("broker down")
        self.connected_to_broker = True
        # paho fires on_connect from its network thread post-connect
        if self.on_connect:
            self.on_connect(self, None, None, 0)

    def reconnect(self):
        self.subscriptions.clear()     # clean session: broker state gone
        self.connect(None, None)

    def disconnect(self):
        # graceful: no LWT
        was = self.connected_to_broker
        self.connected_to_broker = False
        if was and self.on_disconnect:
            self.on_disconnect(self, None, None, 0)

    def drop(self):
        """Ungraceful loss (network cut): broker publishes the LWT."""
        self.connected_to_broker = False
        if self.will:
            self.broker.route(*self.will)
        if self.on_disconnect:
            self.on_disconnect(self, None, None, 7)

    def loop_start(self):
        pass

    def loop_stop(self):
        pass

    # -- messaging ----------------------------------------------------------
    def subscribe(self, topic):
        # real brokers resend retained state on EVERY SUBSCRIBE packet
        # (not just the first): a late-joining host must receive the
        # retained registrar boot record on its connect resubscribe
        self.subscriptions.add(topic)
        if self.connected_to_broker:
            self.broker.send_retained(self, topic)

    def unsubscribe(self, topic):
        self.subscriptions.discard(topic)

    def publish(self, topic, payload, retain=False):
        self.broker.route(topic, payload, retain)
        return _PublishInfo()

    def deliver(self, topic, payload):
        if self.on_message:
            message = type("M", (), {"topic": topic,
                                     "payload": payload.encode()
                                     if isinstance(payload, str)
                                     else payload})
            self.on_message(self, None, message)

    def will_set(self, topic, payload, retain=False):
        self.will = (topic, payload, retain)

    def username_pw_set(self, username, password):
        pass
