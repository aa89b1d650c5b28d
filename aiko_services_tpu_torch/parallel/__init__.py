# Parallelism substrate of the port: meshes over torch.distributed
# process groups, sharding rules onto DTensor placements, collectives,
# ring attention, the training step, checkpoints and pipeline stages.
# Counterpart of aiko_services_tpu/parallel/, with the same exports.

from .mesh import (                                         # noqa: F401
    AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_SEQUENCE, AXIS_STAGE,
    MeshSpec, best_mesh_shape, create_mesh, devices, single_device_mesh,
)
from .sharding import (                                     # noqa: F401
    DEFAULT_RULES, ShardingRules, constrain, named_sharding, replicated,
    shard_pytree,
)
from .collectives import (                                  # noqa: F401
    all_gather, axis_index, axis_size, device_transfer, pmax, pmean,
    ppermute_ring, psum, reduce_scatter, ring_neighbours,
)
from .ring_attention import (                               # noqa: F401
    attention_reference, ring_attention, ring_attention_sharded,
)
from .checkpoint import (                                   # noqa: F401
    CheckpointManager, restore_checkpoint, save_checkpoint,
)
from .pipeline_parallel import (                            # noqa: F401
    StagedExecutor, gpipe_spmd, stage_device_groups,
)
from .train import (                                        # noqa: F401
    TrainState, cross_entropy_loss, cross_entropy_sum, init_train_state,
    make_train_step,
)
