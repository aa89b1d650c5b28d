# Connection-state ladder for a process's control-plane link.
# (capability parity: aiko_services/connection.py:12-46 — ordered states,
# "is_connected(state)" means at-or-above, handler fan-out on change)
#
# The port's own copy of aiko_services_tpu/connection.py.

from __future__ import annotations

from enum import IntEnum

__all__ = ["ConnectionState", "Connection"]


class ConnectionState(IntEnum):
    NONE = 0          # no connectivity
    NETWORK = 1       # host networking up
    BOOTSTRAP = 2     # broker located
    TRANSPORT = 3     # transport connected
    REGISTRAR = 4     # registrar discovered — fully joined


class Connection:
    def __init__(self):
        self._state = ConnectionState.NONE
        self._handlers = []

    @property
    def state(self) -> ConnectionState:
        return self._state

    def is_connected(self, at_least: ConnectionState) -> bool:
        return self._state >= at_least

    def add_handler(self, handler) -> None:
        """handler(connection, state); fired immediately with current state."""
        self._handlers.append(handler)
        handler(self, self._state)

    def remove_handler(self, handler) -> None:
        if handler in self._handlers:
            self._handlers.remove(handler)

    def update(self, state: ConnectionState) -> None:
        if state == self._state:
            return
        self._state = state
        for handler in list(self._handlers):
            handler(self, state)
