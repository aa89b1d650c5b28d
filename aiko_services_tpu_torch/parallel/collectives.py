# Collective communication over the axes of a device mesh.
#
# Counterpart of aiko_services_tpu/parallel/collectives.py.  Inside a JAX
# shard_map the collectives name an axis and XLA finds its devices; here
# each rank is a process, so every collective names its axis AND the mesh
# whose dimension it runs over, and maps onto a torch.distributed
# operation on that dimension's process group (mesh.get_group(axis)):
# NCCL on the card, gloo for CPU tensors.  shard_map is the seam between
# global tensors (DTensors, or full tensors every rank holds) and the
# per-rank bodies that call these collectives.

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharding import NamedSharding, distribute, placements

__all__ = ["psum", "psum_", "pmean", "pmax", "all_gather", "greedy_pick",
           "greedy_pick_scored", "shifted_logsumexp", "mask_vocab_padding",
           "vocab_offset", "axis_spans", "copy_to_axis", "reduce_from_axis",
           "ppermute_ring",
           "reduce_scatter", "axis_index", "axis_size", "device_transfer",
           "ring_neighbours", "shard_map", "axis_fabric",
           "mesh_fabric_report", "reshard", "collective_bytes"]


def _group(mesh, axis_name):
    return mesh.get_group(axis_name)


def psum(x, axis_name, *, mesh):
    """Sum of x over the ranks along `axis_name` (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(mesh, axis_name))
    return out


def axis_spans(mesh, axis_name) -> bool:
    """Whether `axis_name` names an axis of `mesh` (None: no mesh) that
    spans more than one rank: where a sharded program needs its
    collectives."""
    return mesh is not None and axis_name in mesh.mesh_dim_names and \
        axis_size(axis_name, mesh=mesh) > 1


def psum_(x, axis_name, *, mesh):
    """Sum x over the ranks along `axis_name` IN PLACE and return it: the
    row-parallel outputs (attention's o, the FFN's down, the expert
    FFN), each rank's product a partial sum.  Without a mesh, or on an
    axis of one rank (or one the mesh lacks), no collective is called."""
    if axis_spans(mesh, axis_name):
        dist.all_reduce(x, op=dist.ReduceOp.SUM,
                        group=_group(mesh, axis_name))
    return x


class _CopyToAxis(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromAxis(torch.autograd.Function):
    """The sum over the axis forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_axis(x, axis_name, *, mesh):
    """x, the same on every rank of `axis_name`, entering a column-
    parallel product (q / k / v, the FFN's in, the vocab-sharded head):
    the identity, whose gradient is summed over the axis, because each
    rank's product over its slice of the output contributes a part of
    x's gradient.  Megatron's "f".  Without a spanning axis it is x."""
    if not axis_spans(mesh, axis_name):
        return x
    return _CopyToAxis.apply(x, _group(mesh, axis_name))


def reduce_from_axis(x, axis_name, *, mesh):
    """The sum of each rank's partial x over `axis_name` (a row-parallel
    product, a vocab-sharded lookup), into a new tensor, whose gradient
    passes unchanged to every rank: the consumer downstream is the same
    on every rank, so each rank's partial takes the whole gradient.
    Megatron's "g".  torch.distributed.nn's all_reduce would sum the
    gradient over the axis as well, giving every parameter upstream n
    times its gradient.  Without a spanning axis it is x."""
    if not axis_spans(mesh, axis_name):
        return x
    return _ReduceFromAxis.apply(x, _group(mesh, axis_name))


def greedy_pick(logits, axis_name, *, mesh):
    """The greedy token of vocab-sharded logits: logits [..., V / n] are
    this rank's contiguous vocabulary shard along `axis_name`, equal
    chunks (an uneven split's padding columns at -inf:
    mask_vocab_padding); returns the global argmax [...] int32, the same
    on every rank.  Each rank's local max and its global index (first
    maximal, as torch.argmax) are gathered in one collective; the
    largest value wins and, at equal values, the smallest index:
    jnp.argmax's first-index rule over the whole vocabulary.  A rank of
    one makes no collective call."""
    return greedy_pick_scored(logits, axis_name, mesh=mesh)[0]


def vocab_offset(logits_width: int, axis_name, *, mesh) -> int:
    """The global index of this rank's first vocabulary column: shards
    are equal chunks (padded where the vocabulary does not divide)."""
    return axis_index(axis_name, mesh=mesh) * logits_width


def mask_vocab_padding(logits, axis_name, *, mesh, vocab: int):
    """logits [..., chunk] of this rank's vocabulary shard with every
    column at or past `vocab` (the padding of an uneven split) at -inf;
    unchanged when no column is padding."""
    width = logits.shape[-1]
    offset = vocab_offset(width, axis_name, mesh=mesh) \
        if axis_spans(mesh, axis_name) else 0
    if offset + width <= vocab:
        return logits
    ids = torch.arange(width, device=logits.device) + offset
    return logits.masked_fill(ids >= vocab, float("-inf"))


def greedy_pick_scored(logits, axis_name, *, mesh):
    """greedy_pick and the winning logit: (token [...] int32, its value
    [...] in logits' dtype), both the same on every rank (the value is
    the largest logit of the whole vocabulary)."""
    index = torch.argmax(logits, dim=-1)
    value = torch.gather(logits, -1, index[..., None])[..., 0]
    if not axis_spans(mesh, axis_name):
        return index.to(torch.int32), value
    index = index + vocab_offset(logits.shape[-1], axis_name, mesh=mesh)
    # f64 holds an f32 value and an int32 index exactly: one all_gather
    pair = torch.stack([value.double(), index.double()], dim=-1)
    pairs = all_gather(pair, axis_name, tiled=False, mesh=mesh)  # [n,...,2]
    values, indices = pairs[..., 0], pairs[..., 1]
    best = values.amax(dim=0)
    indices = torch.where(values == best, indices,
                          torch.full_like(indices, float("inf")))
    return indices.amin(dim=0).to(torch.int32), best.to(logits.dtype)


def shifted_logsumexp(logits, axis_name, *, mesh):
    """(top, log Σ exp(logits - top)) over the last axis of vocab-
    sharded logits and every shard along `axis_name` (each [...] f32,
    the same on every rank): top is the largest logit of the whole
    vocabulary, taken without a gradient (the sum does not depend on
    it); the shifted exponentials' sums are summed through
    reduce_from_axis, so the gradient reaches every shard.  Padding
    columns must be -inf (mask_vocab_padding)."""
    logits = logits.float()
    with torch.no_grad():
        top = logits.amax(dim=-1)
        if axis_spans(mesh, axis_name):
            top = pmax(top, axis_name, mesh=mesh)
    total = torch.exp(logits - top[..., None]).sum(dim=-1)
    return top, torch.log(reduce_from_axis(total, axis_name, mesh=mesh))


def pmean(x, axis_name, *, mesh):
    return psum(x, axis_name, mesh=mesh) / axis_size(axis_name, mesh=mesh)


def pmax(x, axis_name, *, mesh):
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(mesh, axis_name))
    return out


def all_gather(x, axis_name, axis: int = 0, tiled: bool = True, *, mesh):
    """Every rank's x along `axis_name`, in rank order: concatenated on
    `axis` (tiled) or stacked on a new `axis`."""
    parts = [torch.empty_like(x) for _ in range(axis_size(axis_name,
                                                          mesh=mesh))]
    dist.all_gather(parts, x.contiguous(), group=_group(mesh, axis_name))
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x, axis_name, axis: int = 0, *, mesh):
    """psum, then this rank's chunk of the sum along `axis` (JAX's tiled
    psum_scatter; the sum is formed in full on every rank, which gloo
    needs: it has no reduce-scatter)."""
    chunks = psum(x, axis_name, mesh=mesh).chunk(
        axis_size(axis_name, mesh=mesh), dim=axis)
    return chunks[axis_index(axis_name, mesh=mesh)].contiguous()


def axis_index(axis_name, *, mesh) -> int:
    return mesh.get_local_rank(axis_name)


def axis_size(axis_name, *, mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def ring_neighbours(n: int, reverse: bool = False):
    """Permutation table sending shard j → j+1 (mod n): the ring."""
    if reverse:
        return [(j, (j - 1) % n) for j in range(n)]
    return [(j, (j + 1) % n) for j in range(n)]


def ppermute_ring(x, axis_name, n: int, reverse: bool = False, *, mesh):
    """Rotate x one hop around the ring of `axis_name` (ring attention,
    pipeline-parallel stage handoff): this rank's x goes to the next
    rank, the previous rank's arrives, as one paired isend / irecv."""
    if n == 1:
        return x
    group = _group(mesh, axis_name)
    me = axis_index(axis_name, mesh=mesh)
    step = -1 if reverse else 1
    send_to = dist.get_global_rank(group, (me + step) % n)
    recv_from = dist.get_global_rank(group, (me - step) % n)
    out = torch.empty_like(x)
    requests = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), send_to, group),
        dist.P2POp(dist.irecv, out, recv_from, group)])
    for request in requests:
        request.wait()
    return out


def _to_local(x, mesh, spec):
    return distribute(x, NamedSharding(mesh, tuple(spec))).to_local()


def shard_map(fn, mesh, in_specs, out_specs):
    """The counterpart of jax.shard_map: returns f(*args) that hands
    fn this rank's shard of each tensor argument (its spec: a tuple of
    mesh axes or None per dimension, () replicated) and returns fn's
    output as a DTensor with `out_specs` (a list of specs for several
    outputs).  fn calls the collectives with the mesh."""
    from torch.distributed.tensor import DTensor

    def wrap(out, spec):
        return DTensor.from_local(out, mesh, placements(mesh, spec),
                                  run_check=False)

    def mapped(*args):
        local = [_to_local(arg, mesh, spec)
                 for arg, spec in zip(args, in_specs)]
        out = fn(*local)
        if isinstance(out_specs, list):
            return tuple(wrap(o, s) for o, s in zip(out, out_specs))
        return wrap(out, out_specs)
    return mapped


def device_transfer(x, sharding):
    """Host-side: move x to a device (torch.device) or onto a mesh
    (NamedSharding).  A copy to the card does not wait for it."""
    if isinstance(sharding, NamedSharding):
        return distribute(x, sharding)
    return x.to(sharding, non_blocking=True)


# -- mesh-aware helpers -------------------------------------------------------
# Axes whose ranks share a host ride its fast links (NVLink between the
# cards of one host: JAX's "ici"); axes spanning hosts ride the network
# ("dcn").  High-frequency axes (tensor, expert) belong on one host.

def axis_fabric(mesh, axis_name: str) -> str:
    """"ici" if every rank along `axis_name` (for each fixed point of
    the other axes) runs on one host, else "dcn".  A rank's host is
    rank // LOCAL_WORLD_SIZE (the launcher's ranks per host; without
    one, every rank of the group is on this host)."""
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                  dist.get_world_size()))
    ranks = mesh.mesh.movedim(mesh.mesh_dim_names.index(axis_name), -1)
    for row in ranks.reshape(-1, ranks.shape[-1]).tolist():
        if len({rank // per_host for rank in row}) > 1:
            return "dcn"
    return "ici"


def mesh_fabric_report(mesh) -> dict:
    """axis name → "ici"|"dcn" for every mesh axis."""
    return {axis: axis_fabric(mesh, axis) for axis in mesh.mesh_dim_names}


def reshard(x, mesh, partition_spec):
    """Place a full tensor (or reshard a DTensor) onto `mesh` with a spec
    (a tuple of mesh axes or None per dimension)."""
    return distribute(x, NamedSharding(mesh, tuple(partition_spec)))


def collective_bytes(x, axis_name, mesh, op: str = "all_gather") -> int:
    """Wire-byte estimate for a collective over `axis_name`: ring
    algorithms move ~(n-1)/n of the payload per hop; all_gather /
    reduce_scatter move the full gathered size, psum ~2x scatter."""
    n = axis_size(axis_name, mesh=mesh)
    item_bytes = x.numel() * x.element_size()
    if op in ("all_gather",):
        return item_bytes * (n - 1)
    if op in ("reduce_scatter",):
        return item_bytes * (n - 1) // n
    if op in ("psum", "all_reduce"):
        return 2 * item_bytes * (n - 1) // n
    if op in ("ppermute", "ring"):
        return item_bytes
    raise ValueError(f"unknown collective {op!r}")
