# Storage: persistent key/value actor + the discover-call-respond request
# pattern.
#
# The port's own copy of aiko_services_tpu/storage.py: a sqlite-backed
# actor with a command API, plus do_command/do_request — the client-side
# pattern of discovering a service by filter, proxying a call at it, and
# (for requests) collecting an `(item_count N)`-prefixed response stream
# on a private response topic.

from __future__ import annotations

import json
import sqlite3

from .actor import Actor, ActorDiscovery, get_remote_proxy
from .service import ServiceFilter, ServiceProtocol
from .utils import generate, get_logger, parse, parse_int

__all__ = ["Storage", "PROTOCOL_STORAGE", "do_command", "do_request",
           "ResponseCollector"]

PROTOCOL_STORAGE = ServiceProtocol("storage")


class Storage(Actor):
    """Key/value store: `(put key value)`, `(get key response_topic)`,
    `(delete key)`, `(keys response_topic)`.  Values are JSON strings."""

    def __init__(self, runtime, name: str = "storage",
                 database_path: str = ":memory:"):
        super().__init__(runtime, name, PROTOCOL_STORAGE)
        self.logger = get_logger(f"storage.{name}")
        self.connection = sqlite3.connect(database_path)
        self.connection.execute(
            "CREATE TABLE IF NOT EXISTS store "
            "(key TEXT PRIMARY KEY, value TEXT)")
        self.ec_producer.update("database", database_path)

    def put(self, key, value) -> None:
        self.connection.execute(
            "INSERT INTO store (key, value) VALUES (?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
            (str(key), json.dumps(value)))
        self.connection.commit()

    def get(self, key, response_topic) -> None:
        row = self.connection.execute(
            "SELECT value FROM store WHERE key = ?",
            (str(key),)).fetchone()
        items = [json.loads(row[0])] if row else []
        self._respond(response_topic, items)

    def delete(self, key) -> None:
        self.connection.execute("DELETE FROM store WHERE key = ?",
                                (str(key),))
        self.connection.commit()

    def keys(self, response_topic) -> None:
        rows = self.connection.execute(
            "SELECT key FROM store ORDER BY key").fetchall()
        self._respond(response_topic, [r[0] for r in rows])

    def _respond(self, response_topic, items) -> None:
        self.runtime.publish(response_topic,
                             generate("item_count", [str(len(items))]))
        for item in items:
            self.runtime.publish(response_topic,
                                 generate("item", [json.dumps(item)]))

    def stop(self) -> None:
        self.connection.close()
        super().stop()


class ResponseCollector:
    """Collects an `(item_count N)` + `(item ...)`* response stream on a
    private topic."""

    _counter = 0

    def __init__(self, runtime, handler):
        ResponseCollector._counter += 1
        self.runtime = runtime
        self.handler = handler           # handler(items: list)
        self.topic = (f"{runtime.topic_path}/0/response/"
                      f"{ResponseCollector._counter}")
        self.expected = None
        self.items: list = []
        runtime.add_message_handler(self._on_message, self.topic)

    def _on_message(self, _topic, payload) -> None:
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command == "item_count" and params:
            self.expected = parse_int(params[0], 0)
            if self.expected == 0:
                self._finish()
        elif command == "item" and params:
            self.items.append(json.loads(params[0]))
            if self.expected is not None and \
                    len(self.items) >= self.expected:
                self._finish()

    def _finish(self) -> None:
        self.runtime.remove_message_handler(self._on_message, self.topic)
        self.handler(self.items)


def do_command(runtime, protocol_class, service_filter: ServiceFilter,
               command_handler, discovery: ActorDiscovery | None = None):
    """Discover one service matching `service_filter`, build a proxy, and
    invoke command_handler(proxy) exactly once."""
    discovery = discovery or ActorDiscovery(runtime)
    fired = []

    def on_change(command, fields):
        if command == "add" and not fired:
            fired.append(fields)
            proxy = get_remote_proxy(runtime, f"{fields.topic_path}/in",
                                     protocol_class)
            command_handler(proxy)

    discovery.add_handler(on_change, service_filter)
    return discovery


def do_request(runtime, protocol_class, service_filter: ServiceFilter,
               request_handler, response_handler,
               discovery: ActorDiscovery | None = None):
    """do_command + a ResponseCollector: request_handler(proxy, topic)
    issues the call with the private response topic; response_handler
    receives the collected items."""
    collector = ResponseCollector(runtime, response_handler)

    def command_handler(proxy):
        request_handler(proxy, collector.topic)

    return do_command(runtime, protocol_class, service_filter,
                      command_handler, discovery)
