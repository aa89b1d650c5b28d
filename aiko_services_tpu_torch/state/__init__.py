# State: the event engine's timer storage (wheel.py) and the declarative
# StateMachine (fsm.py) the registrar runs on.

from .fsm import StateMachine, StateMachineError            # noqa: F401
from .wheel import TimerWheel                               # noqa: F401

__all__ = ["StateMachine", "StateMachineError", "TimerWheel"]
