# Message transports: the in-memory broker and the interface it
# implements, the chaos seam, MQTT (paho imported only when a real client
# is built) and the peer data plane.

from .chaos import (                                        # noqa: F401
    ChaosBroker, ChaosMessage, FaultPlan, FaultRule,
)
from .memory import MemoryBroker, MemoryMessage              # noqa: F401
from .message import Message, topic_matches                  # noqa: F401
from .mqtt import MQTT_AVAILABLE, MQTTMessage                # noqa: F401
from .peer import (                                         # noqa: F401
    ChaosPeerChannel, MemoryPeerChannel, PeerChannel, PeerHost,
    SocketPeerChannel,
)
