# State: the event engine's timer storage (wheel.py), the declarative
# StateMachine (fsm.py) the registrar runs on, and the session table
# (sessions.py) the agent keeps conversations in; loadgen.py (imported
# by name) is the table's open-loop load generator.

from .fsm import StateMachine, StateMachineError            # noqa: F401
from .sessions import (                                     # noqa: F401
    SessionTable, SessionView, TenantBudget, session_shard,
)
from .wheel import TimerWheel                               # noqa: F401

__all__ = ["StateMachine", "StateMachineError", "TimerWheel",
           "SessionTable", "SessionView", "TenantBudget", "session_shard"]
