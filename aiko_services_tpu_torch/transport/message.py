# Message transport interface: the control-plane seam.
#
# Capability parity with the reference Message ABC
# (reference: aiko_services/message/message.py:11-46): publish / subscribe /
# unsubscribe / last-will-and-testament.  Every implementation delivers
# inbound messages by calling `on_message(topic, payload)` — implementations
# may call it from any thread; the process runtime is responsible for
# marshalling onto its event engine.
#
# The port's own copy of aiko_services_tpu/transport/message.py, with the
# pure-Python topic matcher only.

from __future__ import annotations

from typing import Callable

__all__ = ["Message", "topic_matches"]


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT-style topic match: '+' one level, '#' trailing multi-level."""
    if pattern == topic:
        return True
    p_parts = pattern.split("/")
    t_parts = topic.split("/")
    for i, p in enumerate(p_parts):
        if p == "#":
            return True
        if i >= len(t_parts):
            return False
        if p != "+" and p != t_parts[i]:
            return False
    return len(p_parts) == len(t_parts)


class Message:
    """Abstract pub/sub transport."""

    def __init__(self, on_message: Callable[[str, object], None] | None = None,
                 subscriptions=()):
        self.on_message = on_message
        self.subscriptions: set[str] = set(subscriptions)

    # -- lifecycle --------------------------------------------------------
    def connect(self) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        raise NotImplementedError

    def connected(self) -> bool:
        raise NotImplementedError

    # -- pub/sub ----------------------------------------------------------
    def publish(self, topic: str, payload, retain: bool = False,
                wait: bool = False) -> None:
        raise NotImplementedError

    def subscribe(self, topic: str) -> None:
        raise NotImplementedError

    def unsubscribe(self, topic: str) -> None:
        raise NotImplementedError

    def set_last_will_and_testament(
            self, topic: str, payload, retain: bool = False) -> None:
        raise NotImplementedError
