# aiko_services_tpu_torch: the PyTorch/CUDA port of aiko_services_tpu.
#
# The port's compute plane runs on one NVIDIA H100: plain tensor code is
# PyTorch, and each kernel the JAX package wrote in Pallas is a CUDA C++
# kernel for sm_90a (csrc/, built at first use by ops/kernels.py).  The
# module layout mirrors aiko_services_tpu so each counterpart is found at
# the same relative path.  Nothing here imports jax or aiko_services_tpu.
#
# Device policy: every entry point takes device=None, which means the
# card; the CPU runs only when a caller passes device="cpu" (the tests).

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "torch_dtype"]


def resolve_device(device=None) -> torch.device:
    """None → the CUDA card (raises when there is none); anything else →
    torch.device(device).  The CPU is never chosen implicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "aiko_services_tpu_torch: no CUDA device is available; "
                "pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(dtype) -> torch.dtype:
    """Map a dtype spelling to a torch dtype: a torch dtype passes
    through; numpy dtypes, the JAX scalar types (jnp.bfloat16 /
    jnp.float32, matched by name, so jax is never imported) and the
    strings "bfloat16" / "float32" / "float16" map by name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


# the control plane's API and the operations plane's entry points, as
# the JAX package's __init__ exports them (imported last: they import
# resolve_device above; autoscaler and placement import the modules
# before them).  None of them imports click, paho, PIL or cv2 at module
# level: those load inside the calls that need them.
from . import utils                                         # noqa: E402,F401
from . import event                                         # noqa: E402,F401
from .connection import Connection, ConnectionState         # noqa: E402,F401
from .event import EventEngine, RealClock, VirtualClock     # noqa: E402,F401
from .lease import Lease                                    # noqa: E402,F401
from .process import ProcessRuntime                         # noqa: E402,F401
from .service import (                                      # noqa: E402,F401
    Service, ServiceFields, ServiceFilter, ServiceProtocol, ServiceTags,
    ServiceTopicPath, Services,
)
from .state import StateMachine, StateMachineError          # noqa: E402,F401
from .share import ECConsumer, ECProducer, ServicesCache    # noqa: E402,F401
from .actor import (                                        # noqa: E402,F401
    Actor, ActorDiscovery, ActorMessage, get_public_methods,
    get_remote_proxy,
)
from .registrar import Registrar                            # noqa: E402,F401
from .process_manager import ProcessManager, RestartPolicy  # noqa: E402,F401
from .lifecycle import (                                    # noqa: E402,F401
    LifeCycleClient, LifeCycleManager,
)
from .autoscaler import Autoscaler, ScalePolicy             # noqa: E402,F401
from .placement import (                                    # noqa: E402,F401
    DevicePool, DeviceSlice, PlacementManager,
)
from .recorder import Recorder                              # noqa: E402,F401
from .compute import ComputeRuntime                         # noqa: E402,F401
from .storage import (                                      # noqa: E402,F401
    ResponseCollector, Storage, do_command, do_request,
)
from .transport import (                                    # noqa: E402,F401
    ChaosBroker, ChaosMessage, FaultPlan, FaultRule, MemoryBroker,
    MemoryMessage, Message, MQTT_AVAILABLE, default_broker, topic_matches,
)

__all__ += [
    "__version__", "utils", "event", "Connection", "ConnectionState",
    "EventEngine", "RealClock", "VirtualClock", "Lease", "ProcessRuntime",
    "Service", "ServiceFields", "ServiceFilter", "ServiceProtocol",
    "ServiceTags", "ServiceTopicPath", "Services", "StateMachine",
    "StateMachineError", "ECConsumer", "ECProducer", "ServicesCache",
    "Actor", "ActorDiscovery", "ActorMessage", "get_public_methods",
    "get_remote_proxy", "Registrar", "ProcessManager", "RestartPolicy",
    "LifeCycleClient", "LifeCycleManager", "Autoscaler", "ScalePolicy",
    "DevicePool", "DeviceSlice", "PlacementManager", "Recorder",
    "ComputeRuntime", "ResponseCollector", "Storage", "do_command",
    "do_request", "ChaosBroker", "ChaosMessage", "FaultPlan", "FaultRule",
    "MemoryBroker", "MemoryMessage", "Message", "MQTT_AVAILABLE",
    "default_broker", "topic_matches",
]
