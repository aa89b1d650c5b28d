# Message transports: the in-memory broker and the interface it implements.

from .memory import MemoryBroker, MemoryMessage              # noqa: F401
from .message import Message, topic_matches                  # noqa: F401
