# Sharding rules: logical tensor axes → mesh axes → DTensor placements.
#
# Counterpart of aiko_services_tpu/parallel/sharding.py.  Models name
# their parameters' axes logically ("embed", "heads", "vocab", ...); a
# ShardingRules table maps those to mesh axes, and a spec (one mesh axis
# or None per tensor dimension, JAX's PartitionSpec) becomes DTensor
# placements: Shard(d) on the mesh dimension that tensor dimension d
# maps to, Replicate() on every other.  One model definition then runs
# unsharded on one card or sharded over a mesh of ranks.
#
# Serving takes another form of the same layout: local_shards gives each
# rank its slice of every leaf as a plain tensor (no DTensor, whose
# dispatch would add host cost to every op of a decode round) and the
# rank-local widths (local_config), from which the serving programs size
# their caches and pools and launch the same kernels as unsharded, with
# fewer heads.

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch
from torch import nn

from .mesh import AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_SEQUENCE

__all__ = ["ShardingRules", "DEFAULT_RULES", "NamedSharding",
           "named_sharding", "shard_pytree", "constrain", "replicated",
           "placements", "distribute", "mesh_device", "local_config",
           "local_shards", "cuts_any", "input_axis_max", "padded_chunk",
           "pad_chunk",
           "PADDED_AXES"]


@dataclass
class ShardingRules:
    """logical axis name → mesh axis name (or None = replicate)."""
    rules: dict = field(default_factory=dict)

    def spec(self, *logical_axes) -> tuple:
        return tuple(self.rules.get(axis) for axis in logical_axes)

    def with_overrides(self, **overrides) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(merged)


# The standard megatron-style layout:
#   batch over data axis; attention heads + ffn hidden over model axis;
#   embed/ffn-in replicated within a TP group; sequence over seq axis for
#   context parallelism; experts over the expert axis.
DEFAULT_RULES = ShardingRules({
    "batch": AXIS_DATA,
    "sequence": AXIS_SEQUENCE,
    "heads": AXIS_MODEL,
    "kv_heads": AXIS_MODEL,
    "embed": None,
    "head_dim": None,
    "ffn": AXIS_MODEL,
    "vocab": AXIS_MODEL,
    "expert": AXIS_EXPERT,
    "channels": None,
})


def placements(mesh, spec) -> list:
    """A spec (mesh axis name or None per tensor dimension) → DTensor
    placements, one per mesh dimension.  Axes the mesh lacks replicate."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    result = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None or axis not in names:
            continue
        index = names.index(axis)
        if isinstance(result[index], Shard):
            raise ValueError(f"spec {spec} maps two tensor dimensions to "
                             f"mesh axis {axis!r}")
        result[index] = Shard(dim)
    return result


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the counterpart of jax.sharding.NamedSharding.
    `placements` are the spec's DTensor placements on the mesh."""
    mesh: object
    spec: tuple = ()

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def named_sharding(mesh, *logical_axes, rules: ShardingRules = None):
    rules = rules or DEFAULT_RULES
    spec = rules.spec(*logical_axes)
    # drop mesh axes the mesh doesn't have (e.g. TP rules on a DP-only mesh)
    names = mesh.mesh_dim_names
    return NamedSharding(mesh, tuple(axis if axis in names else None
                                     for axis in spec))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(x, sharding: NamedSharding):
    """A full tensor, the same on every rank of the mesh, → a DTensor
    holding this rank's shard (a local slice: no communication).  A
    DTensor is redistributed instead."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = sharding.mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x.to(mesh_device(mesh)), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, sharding.placements)


def _axes_at(axes_tree, path):
    """The logical axes of the leaf at `path` (names and list indices)
    in a JAX-style axes tree; None (replicate) where the tree stops."""
    node = axes_tree
    for key in path:
        if node is None or isinstance(node, tuple):
            return node
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


# Logical axes whose uneven split is padded, as GSPMD pads it: every
# rank holds an equal contiguous chunk of ceil(width / n) rows, the last
# rank's tail being zero rows past the end.  Whisper's vocabulary is
# odd (51,865).  Every other uneven split (heads, ffn) raises.
PADDED_AXES = ("vocab",)


def padded_chunk(width: int, n: int) -> int:
    """The rows of each rank's chunk of a dimension of `width` split
    over n ranks: ceil(width / n), the padded split's equal chunk."""
    return -(-int(width) // int(n))


def _check_divides(shape, axes, mesh, rules) -> None:
    """Raise where a dimension whose logical axis maps to a mesh axis
    of more than one rank does not divide over it, except the padded
    axes."""
    spec = named_sharding(mesh, *axes, rules=rules).spec if axes else ()
    for dim, (logical, axis) in enumerate(zip(axes or (), spec)):
        if axis is None or logical in PADDED_AXES:
            continue
        n = _axis_size(mesh, axis)
        if shape[dim] % n:
            raise ValueError(
                f"a leaf of shape {tuple(shape)} does not divide over the "
                f"{axis!r} axis of size {n} along dimension {dim} "
                f"({logical!r}; only {', '.join(PADDED_AXES)} is padded)")


def _place(leaf, axes, mesh, rules):
    if mesh.size() == 1:
        # a mesh of one shards nothing: the leaf lives on its device
        return leaf.to(mesh_device(mesh))
    _check_divides(leaf.shape, axes, mesh, rules)
    sharding = replicated(mesh) if axes is None else \
        named_sharding(mesh, *axes, rules=rules)
    return distribute(leaf.detach(), sharding)


def shard_pytree(tree, axes_tree, mesh, rules: ShardingRules = None):
    """Place a parameter tree onto the mesh.

    tree: an nn.Module (its parameters are replaced in place, the axes
    looked up by each parameter's name split at '.', as bridge.py maps
    names onto JAX tree paths) or nested dicts and lists of tensors (a
    new tree is returned).  axes_tree mirrors the JAX param tree, each
    leaf a tuple of logical axis names (or None = replicate).  On a mesh
    of more than one device each leaf becomes a DTensor; on a mesh of one
    it stays a plain tensor on the mesh's device.  A vocab dimension
    that does not divide keeps its global size: DTensor's contiguous
    chunks are then ceil(V / n) rows on every rank but the last, the
    padded split's chunks without their padding rows (the train step
    pads its local views, parallel/train.py), so checkpoints and moments
    hold the real vocabulary only.  Any other dimension that does not
    divide raises ValueError."""
    if isinstance(tree, nn.Module):
        for name, param in list(tree.named_parameters()):
            *owner_path, leaf_name = name.split(".")
            owner = tree.get_submodule(".".join(owner_path))
            axes = _axes_at(axes_tree, name.split("."))
            placed = _place(param.data, axes, mesh, rules)
            setattr(owner, leaf_name, nn.Parameter(
                placed, requires_grad=param.requires_grad))
        return tree

    def walk(node, axes):
        if isinstance(node, dict):
            return {key: walk(value, _axes_at(axes, [key]))
                    for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(value, _axes_at(axes, [i]))
                    for i, value in enumerate(node)]
        return _place(node, axes, mesh, rules)
    return walk(tree, axes_tree)


def constrain(x, mesh, *logical_axes, rules: ShardingRules = None):
    """with_sharding_constraint under logical names: a DTensor is
    redistributed to them, a full tensor distributed (its local shard
    kept); on a mesh of one, a no-op."""
    if mesh.size() == 1:
        return x
    return distribute(x, named_sharding(mesh, *logical_axes, rules=rules))


# -- rank-local shards (sharded serving) ----------------------------------------

def _axis_size(mesh, axis) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def local_config(config, mesh, rules: ShardingRules = None):
    """The rank-local widths of a (global) LlamaConfig on `mesh`: its
    num_heads, num_kv_heads, ffn_dim and vocab divided by the size of the
    mesh axis their logical axes map to (the model axis under
    DEFAULT_RULES), num_experts by the expert axis's, and head_shards set
    to the heads' divisor, so head_dim stays the model's.  Caches, pools
    and side buffers sized from it are this rank's.  Raises ValueError
    where a width does not divide, as JAX's device_put does: the Llama
    serving programs pick their tokens without the vocabulary's size,
    so they take no padded vocabulary (Whisper's functions do: they
    take the model's config and the mesh, models/whisper.py)."""
    rules = rules or DEFAULT_RULES
    if config.head_shards != 1:
        raise ValueError("local_config takes the model's config, not a "
                         "rank-local one")
    widths = {}
    for field_name, logical in (("num_heads", "heads"),
                                ("num_kv_heads", "kv_heads"),
                                ("ffn_dim", "ffn"), ("vocab", "vocab"),
                                ("num_experts", "expert")):
        width = getattr(config, field_name)
        n = _axis_size(mesh, rules.rules.get(logical))
        if width % n:
            raise ValueError(
                f"{field_name} {width} does not divide over the "
                f"{rules.rules.get(logical)!r} axis of size {n} (a "
                f"Llama config's widths must divide, as JAX's placement "
                f"needs)")
        widths[field_name] = width // n
    return dataclasses.replace(
        config, **widths,
        head_shards=config.num_heads // widths["num_heads"])


def kv_head_range(config, mesh, rules: ShardingRules = None) -> tuple:
    """(first, stop) of this rank's KV heads of a (global) LlamaConfig on
    `mesh`: the contiguous chunk local_shards cuts the K and V
    projections' kv_heads axis to, so a whole KV block's rows [H, B, D]
    sliced [first:stop] are what this rank's pool holds of it."""
    rules = rules or DEFAULT_RULES
    local = local_config(config, mesh, rules).num_kv_heads
    axis = rules.rules.get("kv_heads")
    index = mesh.get_local_rank(axis) \
        if axis in (mesh.mesh_dim_names or ()) else 0
    return index * local, (index + 1) * local


def input_axis_max(mesh, axes_tree, rules: ShardingRules = None):
    """quantize_linear_tree's input_max for this rank's shards on
    `mesh`: a linear whose input axis maps to a mesh axis of more than
    one rank (the row-parallel o and down over the model axis) takes
    each output channel's max over that axis's group (collectives.pmax),
    so its scales are the whole weight's and each rank's int8 weight its
    slice of the unsharded quantization; every other linear (its input
    axis whole: q, k, v, gate, up, the head, a fused projection the axes
    tree does not name) keeps its own max."""
    from .collectives import axis_spans, pmax
    rules = rules or DEFAULT_RULES

    def reduce(path, amax):
        try:
            axes = _axes_at(axes_tree, list(path) + ["w"])
        except (KeyError, IndexError, TypeError):
            axes = None
        axis = rules.rules.get(axes[0]) if axes else None
        if axis is None or not axis_spans(mesh, axis):
            return amax
        return pmax(amax, axis, mesh=mesh)
    return reduce


def pad_chunk(part, dim: int, rows: int):
    """part with zero rows appended along `dim` up to `rows` (a padded
    split's short last chunk); part itself when it has them."""
    short = rows - part.shape[dim]
    if short <= 0:
        return part
    pad = [0, 0] * (part.ndim - 1 - dim) + [0, short]
    return torch.nn.functional.pad(part, pad)


def _local_leaf(leaf, axes, mesh, rules, device):
    """This rank's slice of a full leaf, on `device`: each dimension whose
    logical axis maps to a mesh axis is cut to the rank's contiguous
    chunk along it (the chunk DTensor's Shard gives the same rank); a
    vocab dimension that does not divide is padded with zero rows to
    ceil(V / n) a rank first (PADDED_AXES), every other raises.  A leaf
    that is not cut moves without a copy; a cut one is copied, so the
    full tensor can be freed."""
    _check_divides(leaf.shape, axes, mesh, rules)
    spec = named_sharding(mesh, *axes, rules=rules).spec if axes else ()
    part = leaf.detach()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = _axis_size(mesh, axis)
        chunk = padded_chunk(part.shape[dim], n)
        start = min(mesh.get_local_rank(axis) * chunk, part.shape[dim])
        part = pad_chunk(part.narrow(
            dim, start, min(chunk, part.shape[dim] - start)), dim, chunk)
    if part.shape == leaf.shape:
        return part.to(device)
    return part.to(device, copy=True, memory_format=torch.contiguous_format)


def cuts_any(tree, axes_tree, mesh, rules: ShardingRules = None) -> bool:
    """Whether local_shards would cut any leaf of `tree` on `mesh`: some
    leaf's logical axis maps to a mesh axis of more than one rank (a
    Whisper tree on an expert-only mesh cuts nothing)."""
    from ..models.layers import tree_leaves
    rules = rules or DEFAULT_RULES
    for path, _ in tree_leaves(tree):
        axes = _axes_at(axes_tree, [str(key) for key in path])
        spec = named_sharding(mesh, *axes, rules=rules).spec \
            if axes else ()
        if any(axis is not None and _axis_size(mesh, axis) > 1
               for axis in spec):
            return True
    return False


def local_shards(tree, axes_tree, mesh, rules: ShardingRules = None,
                 config=None):
    """(this rank's shards of `tree`, the rank-local config).

    tree: an nn.Module (read through its parameter names, as
    shard_pytree does) or nested dicts and lists of full tensors, the
    same on every rank; axes_tree mirrors the JAX param tree.  Returns
    nested dicts and lists of plain tensors on the rank's device (the
    serving programs read both forms alike), each leaf cut along the
    mesh axes its logical axes map to (replicated over every other, the
    data axis included), and local_config(config, mesh, rules), or None
    without a config.  A vocab dimension that does not divide is padded
    to equal chunks of ceil(V / n) rows (zero rows past the end: the
    logits' consumers mask them, collectives.mask_vocab_padding); any
    other dimension that does not divide raises ValueError."""
    from ..models.layers import as_tree

    local = None if config is None else local_config(config, mesh, rules)
    device = mesh_device(mesh)

    def walk(node, axes):
        if isinstance(node, dict):
            return {key: walk(value, _axes_at(axes, [key]))
                    for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(value, _axes_at(axes, [i]))
                    for i, value in enumerate(node)]
        return _local_leaf(node, axes, mesh, rules, device)
    return walk(as_tree(tree), axes_tree), local
