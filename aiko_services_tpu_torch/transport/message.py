# Message transport interface: the control-plane seam.
#
# Capability parity with the reference Message ABC
# (reference: aiko_services/message/message.py:11-46): publish / subscribe /
# unsubscribe / last-will-and-testament.  Every implementation delivers
# inbound messages by calling `on_message(topic, payload)` — implementations
# may call it from any thread; the process runtime is responsible for
# marshalling onto its event engine.
#
# The port's own copy of aiko_services_tpu/transport/message.py: the
# topic matcher dispatches to the port's native extension (native/) when
# it builds, with the pure-Python matcher as its plain version.

from __future__ import annotations

from typing import Callable

__all__ = ["Message", "topic_matches"]


def _py_topic_matches(pattern: str, topic: str) -> bool:
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


def _select_topic_matches():
    try:
        from ..native import NATIVE_AVAILABLE, native_topic_matches
        if NATIVE_AVAILABLE:
            return native_topic_matches
    except Exception:
        pass
    return _py_topic_matches


_impl_topic_matches = None


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT-style topic match: '+' one level, '#' trailing multi-level.
    Native (C++) implementation when the toolchain built it; Python
    plain version otherwise (parity tested in
    tests/test_torch_native.py)."""
    global _impl_topic_matches
    if _impl_topic_matches is None:
        _impl_topic_matches = _select_topic_matches()
    return _impl_topic_matches(pattern, topic)


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
