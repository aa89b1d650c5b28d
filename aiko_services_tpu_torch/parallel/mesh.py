# Device meshes: torch.distributed process groups with named axes.
#
# Counterpart of aiko_services_tpu/parallel/mesh.py.  A JAX mesh lays
# devices out under named axes and XLA inserts collectives; here a mesh
# is a torch DeviceMesh over the ranks of the default process group (one
# rank per card, NCCL on the card, gloo for CPU tensors) with the same
# axis names, and each mesh dimension has its own process group for the
# collectives (parallel/collectives.py).  With one process the mesh is a
# mesh of one.

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["AXIS_DATA", "AXIS_MODEL", "AXIS_SEQUENCE", "AXIS_EXPERT",
           "AXIS_STAGE", "MeshSpec", "create_mesh", "single_device_mesh",
           "best_mesh_shape", "devices", "CPU_DEVICES"]

# Canonical mesh axis names.  Shardings and models refer to these, so a
# pipeline definition only has to pick sizes.
AXIS_DATA = "data"          # batch / replica axis (DP)
AXIS_MODEL = "model"        # tensor-parallel axis
AXIS_SEQUENCE = "seq"       # sequence/context-parallel axis (ring attention)
AXIS_EXPERT = "expert"      # expert-parallel axis (MoE)
AXIS_STAGE = "stage"        # pipeline-parallel stage axis

# devices("cpu"): the CPU as this many logical devices, the JAX tests'
# virtual CPU device count (tests/conftest.py forces 8)
CPU_DEVICES = 8


@dataclass
class MeshSpec:
    """Declarative mesh request: axis name → size.  Size -1 on at most one
    axis means "all remaining devices"."""
    axes: dict = field(default_factory=dict)

    def resolve(self, device_count: int) -> dict:
        axes = {k: v for k, v in self.axes.items() if v != 1 or len(
            self.axes) == 1}
        wildcard = [k for k, v in axes.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = math.prod(v for v in axes.values() if v != -1)
        if wildcard:
            if device_count % fixed:
                raise ValueError(
                    f"cannot fill axis {wildcard[0]}: {device_count} devices "
                    f"not divisible by {fixed}")
            axes[wildcard[0]] = device_count // fixed
        elif fixed != device_count:
            raise ValueError(
                f"mesh {axes} wants {fixed} devices, have {device_count}")
        return axes


def best_mesh_shape(device_count: int, model_parallel: int = 1) -> dict:
    """Default 2D layout: model axis innermost (neighbouring ranks share
    the fastest links for TP collectives), data axis over the rest."""
    if device_count % model_parallel:
        raise ValueError(f"{device_count} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return {AXIS_DATA: device_count // model_parallel,
            AXIS_MODEL: model_parallel}


def devices(device=None) -> list:
    """The port's counterpart of jax.devices(): the devices one process
    may place work on.  device=None (the card) → every visible CUDA
    device, so one H100 is one device, as one TPU is under JAX;
    device="cpu" → the CPU named CPU_DEVICES times as logical devices,
    as the JAX tests' virtual CPU devices are (code that groups devices,
    StagedExecutor, runs on the CPU as it does under JAX)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)] * CPU_DEVICES


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _process_group(device: torch.device) -> None:
    """The default process group for `device`'s tensors: NCCL for the
    card, gloo for the CPU.  A process that has none joins the group its
    launcher describes when WORLD_SIZE is above one (one process per
    rank, as torchrun starts them: RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT from the environment, the card LOCAL_RANK), else gets a
    group of one; a group of the other backend raises (never a
    fallback)."""
    backend = _backend(device)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://")
            return
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"the process group's backend is {have}, "
                         f"{device.type} tensors need {backend}")


def create_mesh(axes: dict | MeshSpec | None = None, device=None):
    """Build a DeviceMesh over the ranks of the default process group.

    axes: {"data": 2, "model": 2} (ordering = mesh dims, model-like axes
    last).  None → a 1D data mesh over every rank.  device=None means
    the card (NCCL); "cpu" builds a gloo mesh.  A process without a
    process group gets a group of one: a mesh of one."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    _process_group(device)
    world = dist.get_world_size()
    if axes is None:
        axes = {AXIS_DATA: world}
    if not isinstance(axes, MeshSpec):
        axes = MeshSpec(dict(axes))
    axes = axes.resolve(world)
    return init_device_mesh(device.type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes.keys()))


def single_device_mesh(axis: str = AXIS_DATA, device=None):
    """1-device mesh: lets single-card code paths share the sharded code
    path.  Needs a process group of one (or none yet): the ranks of a
    larger group build their meshes together with create_mesh."""
    device = resolve_device(device)
    _process_group(device)
    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a process group of "
                         f"one, this one has {dist.get_world_size()} "
                         f"ranks: build the mesh with create_mesh")
    return create_mesh({axis: 1}, device)
