# Tensor ops of the port: attention (and its CUDA kernels), the audio
# frontend, admission and the batching scheduler (re-exported here, as
# the JAX package's ops/__init__.py does), and the kernels' build and
# loader.

from .admission import (                                    # noqa: F401
    AdmissionGate, TenantFairQueue, TenantPolicy,
)
from .batching import (                                     # noqa: F401
    BatchItem, BatchingScheduler, ShapeBuckets,
)

__all__ = ["AdmissionGate", "BatchItem", "BatchingScheduler",
           "ShapeBuckets", "TenantFairQueue", "TenantPolicy"]
