# In-memory broker: full pub/sub semantics without a network.
#
# The reference has no test transport (its only impl is paho-mqtt,
# aiko_services/message/mqtt.py:64); this broker is the designed-in seam the
# survey calls for (SURVEY.md §4): retained messages, +/# wildcards, and
# last-will-and-testament, so an entire multi-"process" distributed system —
# registrar failover included — runs deterministically inside one pytest.
#
# Routing is INDEXED: exact-topic subscriptions hash-match in O(1) through
# a topic map, wildcard patterns walk a per-level subscription trie, and
# delivery happens OUTSIDE the broker lock through per-client FIFO queues.
# Data-plane topics (opt-in via mark_data_plane) get BOUNDED per-client
# queues with an explicit drop policy — a slow consumer sheds its own
# stale frames instead of back-pressuring the broker, and control-plane
# messages are never dropped.  Payloads may be text or bytes (binary wire
# envelopes, transport/wire.py): MemoryMessage declares BINARY.
#
# The port's own copy of aiko_services_tpu/transport/memory.py.

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Callable

from ..observe.metrics import MirroredStats
from ..utils.lock import Lock
from .message import Message, topic_matches

__all__ = ["MemoryBroker", "MemoryMessage"]


class _TrieNode:
    """One topic level of the wildcard-subscription trie."""
    __slots__ = ("children", "plus", "multi", "leaf")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.plus: _TrieNode | None = None      # '+' single-level branch
        self.multi: set = set()                 # clients with '#' here
        self.leaf: set = set()                  # patterns ending here

    def empty(self) -> bool:
        return not (self.children or self.plus or self.multi or self.leaf)


class _SubscriptionTrie:
    """MQTT wildcard patterns ('+' one level, trailing '#') -> clients."""

    def __init__(self):
        self._root = _TrieNode()

    def insert(self, pattern: str, client) -> None:
        node = self._root
        for part in pattern.split("/"):
            if part == "#":
                node.multi.add(client)
                return
            if part == "+":
                if node.plus is None:
                    node.plus = _TrieNode()
                node = node.plus
            else:
                node = node.children.setdefault(part, _TrieNode())
        node.leaf.add(client)

    def remove(self, pattern: str, client) -> None:
        path = []                       # (parent, key) trail for pruning
        node = self._root
        for part in pattern.split("/"):
            if part == "#":
                node.multi.discard(client)
                break
            if part == "+":
                if node.plus is None:
                    return
                path.append((node, "+"))
                node = node.plus
            else:
                child = node.children.get(part)
                if child is None:
                    return
                path.append((node, part))
                node = child
        else:
            node.leaf.discard(client)
        while path and node.empty():
            parent, key = path.pop()
            if key == "+":
                parent.plus = None
            else:
                del parent.children[key]
            node = parent

    def match(self, topic: str) -> set:
        out: set = set()
        nodes = [self._root]
        for part in topic.split("/"):
            next_nodes = []
            for node in nodes:
                out |= node.multi           # "a/#" matches "a/b/..."
                child = node.children.get(part)
                if child is not None:
                    next_nodes.append(child)
                if node.plus is not None:
                    next_nodes.append(node.plus)
            nodes = next_nodes
            if not nodes:
                return out
        for node in nodes:
            out |= node.leaf
            out |= node.multi               # MQTT: "a/#" matches "a" too
        return out


class MemoryBroker:
    """A process-local mosquitto: routes, retains, and fires LWTs.

    data_queue_limit bounds each client's pending DATA-plane messages
    (topics registered via mark_data_plane); control-plane queues are
    unbounded so protocol messages can never be shed."""

    def __init__(self, data_queue_limit: int = 1024):
        self._lock = threading.RLock()
        self._clients: dict["MemoryMessage", int] = {}   # client -> seq
        self._seq = itertools.count()
        self._exact: dict[str, set] = {}
        self._trie = _SubscriptionTrie()
        self._retained: dict[str, object] = {}
        self._data_patterns: list[str] = []
        self.data_queue_limit = data_queue_limit
        # best-effort counters: delivered/dropped increment outside the
        # broker lock (per-client paths), so concurrent publishers may
        # lose the odd count — they are diagnostics, not invariants.
        # Mirrored onto the process metrics registry:
        # broker_messages_total{kind=...} aggregates across every
        # broker instance in the process
        self.stats = MirroredStats(
            {"routed": 0, "delivered": 0, "dropped": 0},
            metric="broker_messages_total",
            help="in-memory broker routing events by kind")

    # -- client management -------------------------------------------------
    def attach(self, client: "MemoryMessage") -> None:
        with self._lock:
            if client not in self._clients:
                self._clients[client] = next(self._seq)
                for pattern in client.subscriptions:
                    self._index(client, pattern)

    def detach(self, client: "MemoryMessage", fire_lwt: bool = True) -> None:
        with self._lock:
            if client in self._clients:
                del self._clients[client]
                for pattern in client.subscriptions:
                    self._unindex(client, pattern)
        if fire_lwt:
            for topic, payload, retain in list(client.wills):
                # the dying client is the logical sender of its own will
                self.route(topic, payload, retain=retain, sender=client)

    # -- subscription index (lock held by callers below) -------------------
    def _index(self, client, pattern: str) -> None:
        if "+" in pattern or "#" in pattern:
            self._trie.insert(pattern, client)
        else:
            self._exact.setdefault(pattern, set()).add(client)

    def _unindex(self, client, pattern: str) -> None:
        if "+" in pattern or "#" in pattern:
            self._trie.remove(pattern, client)
        else:
            subscribers = self._exact.get(pattern)
            if subscribers is not None:
                subscribers.discard(client)
                if not subscribers:
                    del self._exact[pattern]

    def subscribe(self, client: "MemoryMessage", pattern: str) -> None:
        with self._lock:
            if client in self._clients:
                self._index(client, pattern)

    def unsubscribe(self, client: "MemoryMessage", pattern: str) -> None:
        with self._lock:
            if client in self._clients:
                self._unindex(client, pattern)

    # -- data-plane policy -------------------------------------------------
    def mark_data_plane(self, pattern: str) -> None:
        """Topics matching `pattern` are data plane: a slow consumer's
        pending queue is bounded (data_queue_limit) and overflow is shed
        per the client's drop_policy instead of growing without bound."""
        with self._lock:
            if pattern not in self._data_patterns:
                self._data_patterns.append(pattern)

    def _is_data_topic(self, topic: str) -> bool:
        return any(topic_matches(p, topic) for p in self._data_patterns)

    # -- routing -----------------------------------------------------------
    def route(self, topic: str, payload, retain: bool = False,
              sender=None) -> None:
        with self._lock:
            if retain:
                if payload in ("", b"", None):
                    self._retained.pop(topic, None)   # clear retained
                else:
                    self._retained[topic] = payload
            recipients = self._exact.get(topic, set()) | \
                self._trie.match(topic)
            # deterministic fan-out order: attach order
            ordered = sorted(((self._clients[c], c) for c in recipients
                              if c in self._clients))
            is_data = bool(self._data_patterns) and \
                self._is_data_topic(topic)
            self.stats["routed"] += 1
        # delivery OUTSIDE the lock: a handler that publishes (actors
        # routinely do) re-enters route() without deadlock risk, and a
        # slow handler does not serialize every other publisher
        self._deliver([client for _, client in ordered], topic, payload,
                      is_data, sender)

    def _deliver(self, clients, topic: str, payload, is_data: bool,
                 sender) -> None:
        """Per-recipient delivery, outside the broker lock.  The seam the
        chaos layer (transport/chaos.py) overrides to inject per-delivery
        faults; `sender` is the publishing client (None for retained
        replays), so partition rules can tell sides apart."""
        for client in clients:
            client._enqueue(topic, payload, is_data,
                            self.data_queue_limit, self.stats)

    def deliver_retained(self, client: "MemoryMessage",
                         pattern: str) -> None:
        with self._lock:
            matches = [(t, p) for t, p in self._retained.items()
                       if topic_matches(pattern, t)]
            data_flags = [bool(self._data_patterns) and
                          self._is_data_topic(t) for t, _ in matches]
        # retained replays go through the same per-recipient delivery
        # seam as live messages (sender=None), so chaos rules apply to
        # them too
        for (topic, payload), is_data in zip(matches, data_flags):
            self._deliver([client], topic, payload, is_data, None)

    def retained(self, topic: str):
        with self._lock:
            return self._retained.get(topic)

    def reset(self) -> None:
        """Forget every client, subscription, retained message and
        data-plane pattern (the counters stay)."""
        with self._lock:
            self._clients.clear()
            self._exact.clear()
            self._trie = _SubscriptionTrie()
            self._retained.clear()
            self._data_patterns.clear()


_default_broker = MemoryBroker()
_client_counter = itertools.count()


def default_broker() -> MemoryBroker:
    return _default_broker


class MemoryMessage(Message):
    """Message transport backed by a MemoryBroker.

    Inbound messages flow through a per-client FIFO queue drained outside
    the broker lock; drop_policy ("oldest" | "newest") applies only to
    data-plane topics when the queue is at the broker's bound."""

    BINARY = True       # bytes payloads (wire.py envelopes) pass through

    def __init__(self, on_message: Callable | None = None, subscriptions=(),
                 broker: MemoryBroker | None = None,
                 lwt_topic: str | None = None, lwt_payload=None,
                 lwt_retain: bool = False, drop_policy: str = "oldest",
                 client_id: str | None = None):
        super().__init__(on_message, subscriptions)
        self.broker = broker or _default_broker
        # identity for per-client fault rules (transport/chaos.py); the
        # LWT topic is the natural default — it names the owning process
        self.client_id = client_id or lwt_topic or \
            f"memory-{next(_client_counter)}"
        self.wills: list[tuple[str, object, bool]] = []
        if lwt_topic is not None:
            self.wills.append((lwt_topic, lwt_payload, lwt_retain))
        self._connected = False
        self.drop_policy = drop_policy
        # per-client dict; the registry mirror aggregates across
        # clients (no per-client label: client ids are unbounded)
        self.stats = MirroredStats(
            {"received": 0, "dropped": 0},
            metric="transport_client_messages_total",
            help="per-client transport deliveries/sheds, aggregated")
        # two FIFO lanes with a shared sequence so the drain preserves
        # global arrival order: the data lane is the bounded one, and
        # shedding is O(1) (popleft), never a scan
        self._rx_ctl: deque = deque()       # (seq, topic, payload)
        self._rx_data: deque = deque()
        self._rx_seq = itertools.count()
        self._rx_lock = Lock("memory.rx")
        self._draining = False
        self._held = False

    # -- lifecycle ---------------------------------------------------------
    def connect(self) -> None:
        self.broker.attach(self)
        self._connected = True
        for pattern in list(self.subscriptions):
            self.broker.deliver_retained(self, pattern)

    def disconnect(self, fire_lwt: bool = False) -> None:
        """Graceful disconnect does not fire the LWT (like MQTT DISCONNECT);
        pass fire_lwt=True to simulate a crash / broken session."""
        self.broker.detach(self, fire_lwt=fire_lwt)
        self._connected = False

    def crash(self) -> None:
        """Simulate abrupt process death: broker fires the LWT."""
        self.disconnect(fire_lwt=True)

    def connected(self) -> bool:
        return self._connected

    # -- pub/sub -----------------------------------------------------------
    def publish(self, topic, payload, retain=False, wait=False) -> None:
        self.broker.route(topic, payload, retain, sender=self)

    def subscribe(self, topic) -> None:
        new = topic not in self.subscriptions
        self.subscriptions.add(topic)
        if new:
            self.broker.subscribe(self, topic)
        if self._connected and new:
            self.broker.deliver_retained(self, topic)

    def unsubscribe(self, topic) -> None:
        if topic in self.subscriptions:
            self.subscriptions.discard(topic)
            self.broker.unsubscribe(self, topic)

    def mark_data_plane(self, pattern) -> None:
        """Declare a data-plane topic pattern on the backing broker
        (bounded per-client queues + drop policy; see MemoryBroker)."""
        self.broker.mark_data_plane(pattern)

    def set_last_will_and_testament(self, topic, payload,
                                    retain=False) -> None:
        self.wills = [(topic, payload, retain)]

    def add_last_will_and_testament(self, topic, payload,
                                    retain=False) -> None:
        """Additional will (real MQTT allows one will per connection; a
        registrar over MQTT uses a dedicated connection for this)."""
        self.wills.append((topic, payload, retain))

    def remove_last_will_and_testament(self, topic) -> None:
        self.wills = [w for w in self.wills if w[0] != topic]

    # -- delivery ----------------------------------------------------------
    def hold(self) -> None:
        """Pause delivery: inbound messages queue (tests exercise the
        bounded-queue drop policy with this)."""
        self._held = True

    def release(self) -> None:
        self._held = False
        self._pump()

    def _enqueue(self, topic: str, payload, is_data: bool,
                 limit: int, broker_stats: dict) -> None:
        if not self._connected:
            return
        with self._rx_lock:
            if is_data and limit and len(self._rx_data) >= limit:
                if self.drop_policy == "newest":
                    self.stats["dropped"] += 1
                    broker_stats["dropped"] += 1
                    return
                # "oldest" (default): shed the stalest data frame —
                # streaming consumers want the freshest payload
                self._rx_data.popleft()
                self.stats["dropped"] += 1
                broker_stats["dropped"] += 1
            lane = self._rx_data if is_data else self._rx_ctl
            lane.append((next(self._rx_seq), topic, payload))
        self._pump()

    def _pump(self) -> None:
        """Drain both rx lanes in global FIFO (sequence) order.
        Re-entrancy safe: a handler that publishes back to this client
        appends and returns — the outer drain delivers it, preserving
        order without unbounded recursion."""
        while True:
            with self._rx_lock:
                if self._draining or self._held or \
                        not (self._rx_ctl or self._rx_data):
                    return
                self._draining = True
            try:
                while True:
                    with self._rx_lock:
                        if self._held:
                            break
                        if self._rx_ctl and (
                                not self._rx_data or
                                self._rx_ctl[0][0] < self._rx_data[0][0]):
                            _, topic, payload = self._rx_ctl.popleft()
                        elif self._rx_data:
                            _, topic, payload = self._rx_data.popleft()
                        else:
                            break
                    if self._connected and self.on_message is not None:
                        self.stats["received"] += 1
                        self.broker.stats["delivered"] += 1
                        self.on_message(topic, payload)
            finally:
                with self._rx_lock:
                    self._draining = False
