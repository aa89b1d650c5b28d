# Pipeline parallelism: stages on distinct device groups, frames in
# flight overlapping.
#
# Counterpart of aiko_services_tpu/parallel/pipeline_parallel.py, in two
# granularities:
#   * StagedExecutor: inference PP for element pipelines.  Each stage is
#     a callable pinned to its group's first device with its own params;
#     submit() queues every stage's work on its device and returns the
#     last stage's (still computing) output without waiting: PyTorch
#     launches asynchronously on the card, so consecutive frames overlap
#     across stages, and result() is the one place the host waits.  That
#     holds while the stage functions never synchronize (no .item(), no
#     copy from pageable host memory); chip_smoke.py's staged phase runs
#     submit() under torch.cuda's sync debug mode "error" to prove it.
#   * gpipe_spmd: training-style PP, one rank per stage of the mesh's
#     "stage" axis; microbatches enter stage 0 and activations rotate
#     stage → stage with ppermute_ring (the GPipe schedule).

from __future__ import annotations

import torch

from .collectives import axis_index, axis_size, ppermute_ring, psum
from .mesh import AXIS_STAGE, devices as default_devices

__all__ = ["StagedExecutor", "stage_device_groups", "gpipe_spmd"]


def stage_device_groups(devices, num_stages: int):
    """Split a device list into contiguous per-stage groups (contiguous =
    neighbouring links carry the inter-stage traffic)."""
    devices = list(devices)
    if len(devices) % num_stages:
        raise ValueError(f"{len(devices)} devices not divisible into "
                         f"{num_stages} stages")
    per_stage = len(devices) // num_stages
    return [devices[i * per_stage:(i + 1) * per_stage]
            for i in range(num_stages)]


def _tree_to(tree, device):
    """Every tensor of a tree (a module, nested dicts / lists / tuples)
    on `device`, without a host wait; tensors already there are not
    copied.  A module comes back as nested dicts of its tensors."""
    from ..models.layers import as_tree

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(value) for value in node)
        if isinstance(node, torch.Tensor):
            return node.to(device, non_blocking=True)
        return node
    return walk(as_tree(tree))


class StagedExecutor:
    """Inference pipeline parallelism over device groups.

    stages: list of (fn, params): fn(params, x) -> y, pinned to its
    group's first device with its params placed there once.  devices
    defaults to parallel.devices(): the visible cards.  submit(x) queues
    the whole chain without a host wait, so several frames occupy
    different stages at once; result(y) waits for the value."""

    def __init__(self, stages, devices=None):
        devices = list(devices if devices is not None else default_devices())
        self.groups = stage_device_groups(devices, len(stages))
        self._fns = []
        self._params = []
        for (fn, params), group in zip(stages, self.groups):
            self._fns.append(fn)
            self._params.append(_tree_to(params, group[0]))
        self.in_flight = 0

    def submit(self, x):
        """Queue one frame through every stage; returns the final value
        (on the last stage's device, possibly still computing) at once.
        in_flight counts frames submitted but not yet collect()ed."""
        for index, fn in enumerate(self._fns):
            x = fn(self._params[index], _tree_to(x, self.groups[index][0]))
        self.in_flight += 1
        return x

    def collect(self, y):
        """Wait for a submitted frame's value (host numpy) and retire it
        from the in-flight count."""
        value = self.result(y)
        self.in_flight = max(0, self.in_flight - 1)
        return value

    @staticmethod
    def result(y):
        """Wait for a submitted frame's value (host numpy) without
        touching the in-flight count.  Stage outputs may be tuples (a
        decode stage's (tokens, lengths, scores))."""
        if isinstance(y, (list, tuple)):
            return type(y)(StagedExecutor.result(value) for value in y)
        if isinstance(y, dict):
            return {key: StagedExecutor.result(v) for key, v in y.items()}
        return y.detach().cpu().numpy()

    def map(self, frames):
        """Pipeline a sequence: submit everything (filling all stages),
        then collect in order."""
        pending = [self.submit(frame) for frame in frames]
        return [self.collect(y) for y in pending]


def _local_stage(tree, index: int):
    """This stage's slice of stacked stage params: leaf[index] of full
    tensors, the local [1, ...] shard of DTensors sharded over stages."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {key: _local_stage(value, index) for key, value in tree.items()}
    if isinstance(tree, DTensor):
        return tree.to_local()[0]
    return tree[index]


def gpipe_spmd(stage_fn, mesh, num_microbatches: int,
               axis_name: str = AXIS_STAGE):
    """Build a GPipe-style SPMD step: one rank per stage of `axis_name`,
    microbatches streamed through with ppermute_ring.

    stage_fn(stage_params, x) -> y maps one stage's computation; all
    stages share this code (uniform layers).

    Returns step(stage_params_stacked, microbatches) where
      stage_params_stacked: dict of tensors with leading axis =
        num_stages (full on every rank, or DTensors sharded over
        `axis_name`);
      microbatches: [num_microbatches, batch, ...], the same on every
        rank;
    output: [num_microbatches, batch, ...] after every stage has
    processed every microbatch, the same on every rank.  The schedule is
    n + S - 1 steps: at step t stage 0 ingests microbatch t, the others
    take the carry rotated from their predecessor, the last stage writes
    microbatch t - S + 1, and a final sum broadcasts its buffer."""
    num_stages = axis_size(axis_name, mesh=mesh)

    def step(stage_params, microbatches):
        stage_idx = axis_index(axis_name, mesh=mesh)
        params = _local_stage(stage_params, stage_idx)
        n = num_microbatches
        last = num_stages - 1
        buffer = microbatches.clone()
        carry = torch.zeros_like(buffer[0])
        for t in range(n + num_stages - 1):
            x = buffer[min(t, n - 1)] if stage_idx == 0 else carry
            y = stage_fn(params, x)
            if stage_idx == last and 0 <= t - last < n:
                buffer[t - last] = y
            carry = ppermute_ring(y, axis_name, num_stages, mesh=mesh)
        # only the last stage holds the final outputs: broadcast them
        return psum(buffer if stage_idx == last else
                    torch.zeros_like(buffer), axis_name, mesh=mesh)

    return step
