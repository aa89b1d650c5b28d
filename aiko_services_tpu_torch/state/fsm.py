# Finite state machine with declarative transitions.
#
# Capability parity with the reference StateMachine (aiko_services/state.py:
# 16-61, a wrapper over the external `transitions` package): named states,
# trigger-driven transitions with on_enter callbacks on a delegate object,
# fail-fast on illegal transitions.  Implemented from scratch — no external
# dependency.
#
# The port's own copy of aiko_services_tpu/state/fsm.py.

from __future__ import annotations

__all__ = ["StateMachine", "StateMachineError"]


class StateMachineError(RuntimeError):
    pass


class StateMachine:
    """transitions: list of {"trigger", "source" (str|list|"*"), "dest"};
    on entering state S, delegate.on_enter_S(...) is called if defined."""

    def __init__(self, delegate, states: list[str],
                 transitions: list[dict], initial: str,
                 fail_fast: bool = True):
        self.delegate = delegate
        self.states = list(states)
        self.fail_fast = fail_fast
        self._state = initial
        self._transitions: dict[tuple[str, str], str] = {}
        for t in transitions:
            sources = t["source"]
            if sources == "*":
                sources = self.states
            elif isinstance(sources, str):
                sources = [sources]
            for source in sources:
                self._transitions[(t["trigger"], source)] = t["dest"]

    @property
    def state(self) -> str:
        return self._state

    def transition(self, trigger: str, *args, **kwargs) -> None:
        dest = self._transitions.get((trigger, self._state))
        if dest is None:
            message = (f"illegal transition: trigger {trigger!r} "
                       f"from state {self._state!r}")
            if self.fail_fast:
                raise StateMachineError(message)
            return
        self._state = dest
        handler = getattr(self.delegate, f"on_enter_{dest}", None)
        if handler:
            handler(*args, **kwargs)
