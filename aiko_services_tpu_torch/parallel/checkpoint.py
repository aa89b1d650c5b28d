# Checkpoint / resume for parameter and training state.
#
# Counterpart of aiko_services_tpu/parallel/checkpoint.py, in its flat-npz
# format: one array per leaf under its '/'-joined tree path, plus a
# manifest.json, so a checkpoint written by either package restores in
# the other.  The port's leaves map onto JAX's tree:
#   * an nn.Module's parameter "dec_blocks.3.attn.q.w" is the leaf
#     dec_blocks/3/attn/q/w (bridge.py's naming);
#   * a torch AdamW's state is optax.adamw's (ScaleByAdamState(count, mu,
#     nu), EmptyState(), EmptyState()), whose named tuples flatten by
#     position: 0/0 is the count (torch's step), 0/1/<path> each mu
#     (exp_avg), 0/2/<path> each nu (exp_avg_sq); an SGD without momentum
#     holds no leaves, as optax.sgd's state has none.
# DTensor leaves are gathered in full to save and sliced to each rank's
# shard to restore.  A vocabulary split unevenly over a model axis
# (Whisper's odd one) keeps its global shape at rest, in DTensor's
# uneven chunks: the padding to equal chunks lives only in the train
# step's local views and the serving shards (parallel/sharding.py), so
# a save holds the model's rows and no padding, and a restore cuts them
# back into the same chunks.  Under torch.distributed every rank joins the
# gathers, global rank 0 alone writes, and a barrier holds the others
# until the files are complete: the directory must be one that every
# rank can read.

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager",
           "flatten_tree", "unflatten_into"]


def _named(optimizer) -> list:
    """[(name, param)] of a torch optimizer built from named parameters."""
    pairs = []
    for group in optimizer.param_groups:
        names = group.get("param_names")
        if names is None:
            raise ValueError("checkpoints need an optimizer built from "
                             "named_parameters() (train.adamw / sgd)")
        pairs.extend(zip(names, group["params"]))
    return pairs


def _optimizer_tree(optimizer):
    """A torch optimizer's state in optax's tree layout."""
    if isinstance(optimizer, torch.optim.SGD):
        if any(group.get("momentum") for group in optimizer.param_groups):
            raise ValueError("SGD with momentum has no optax.sgd layout")
        return ((), ())
    if not isinstance(optimizer, torch.optim.AdamW):
        raise TypeError(f"no checkpoint layout for {type(optimizer)}")
    mu, nu, count = {}, {}, 0
    for name, param in _named(optimizer):
        state = optimizer.state.get(param, {})
        path = name.replace(".", "/")
        mu[path] = state.get("exp_avg", torch.zeros_like(param))
        nu[path] = state.get("exp_avg_sq", torch.zeros_like(param))
        count = int(state["step"]) if "step" in state else count
    return ((count, mu, nu), (), ())


def flatten_tree(tree, prefix="") -> dict:
    """tree → {'/'-joined path: leaf} (dicts, lists and tuples; a module
    as its parameters, an optimizer in optax's layout)."""
    if isinstance(tree, nn.Module):
        tree = {name.replace(".", "/"): param
                for name, param in tree.named_parameters()}
    elif isinstance(tree, torch.optim.Optimizer):
        tree = _optimizer_tree(tree)
    flat = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple, nn.Module,
                              torch.optim.Optimizer)):
            flat.update(flatten_tree(value, prefix=f"{path}/"))
        else:
            flat[path] = value
    return flat


def _full(tensor):
    from torch.distributed.tensor import DTensor

    if isinstance(tensor, DTensor):
        return tensor.full_tensor()
    return tensor


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        tensor = _full(value).detach().cpu()
        if tensor.dtype == torch.bfloat16:     # numpy has no bfloat16
            tensor = tensor.float()
        return tensor.numpy()
    return np.asarray(value)


def _like(loaded, template):
    """A loaded array as a tensor shaped, typed and placed like
    `template` (a DTensor template takes this rank's shard)."""
    from torch.distributed.tensor import DTensor

    if tuple(template.shape) != tuple(loaded.shape):
        raise ValueError(f"checkpoint leaf shape {loaded.shape} != "
                         f"template {tuple(template.shape)}")
    full = torch.from_numpy(np.array(loaded, dtype=np.float32)
                            if loaded.dtype.kind == "f" else
                            np.array(loaded)).to(template.dtype)
    if isinstance(template, DTensor):
        from .sharding import NamedSharding, distribute
        mesh = template.device_mesh
        return distribute(full, NamedSharding(mesh, ())).redistribute(
            mesh, template.placements)
    return full.to(template.device)


@torch.no_grad()
def _restore_module(module, flat, prefix):
    for name, param in module.named_parameters():
        key = prefix + name.replace(".", "/")
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf: {key}")
        param.copy_(_like(flat[key], param))
    return module


@torch.no_grad()
def _restore_optimizer(optimizer, flat, prefix):
    if isinstance(optimizer, torch.optim.SGD):
        return optimizer
    count = int(np.asarray(flat[f"{prefix}0/0"]))
    for name, param in _named(optimizer):
        path = name.replace(".", "/")
        state = optimizer.state[param]
        state["step"] = torch.tensor(float(count))
        state["exp_avg"] = _like(flat[f"{prefix}0/1/{path}"], param)
        state["exp_avg_sq"] = _like(flat[f"{prefix}0/2/{path}"], param)
    return optimizer


def unflatten_into(template, flat: dict, prefix=""):
    """Rebuild a tree shaped like `template` from flatten_tree output;
    every template leaf must be present.  Modules and optimizers in the
    template are restored in place and returned; tensor leaves come back
    as tensors of the template leaf's dtype and device."""
    if isinstance(template, nn.Module):
        return _restore_module(template, flat, prefix)
    if isinstance(template, torch.optim.Optimizer):
        return _restore_optimizer(template, flat, prefix)
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        rebuilt = [unflatten_into(v, flat, f"{prefix}{i}/")
                   for i, v in enumerate(template)]
        return tuple(rebuilt) if isinstance(template, tuple) else rebuilt
    key = prefix.rstrip("/")
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf: {key}")
    loaded = flat[key]
    if isinstance(template, torch.Tensor):
        return _like(np.asarray(loaded), template)
    # scalar python leaf (e.g. step counter)
    loaded = np.asarray(loaded)
    return loaded.item() if loaded.shape == () else loaded


def save_checkpoint(directory: str, tree, step: int | None = None) -> str:
    """Write `tree` under `directory` (npz + manifest).  Returns the
    checkpoint path."""
    name = f"step_{step}" if step is not None else "checkpoint"
    path = os.path.join(directory, name)
    arrays = {key: _to_numpy(value)      # every rank joins the gathers
              for key, value in flatten_tree(tree).items()}
    if _writer():
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "state.npz"), **arrays)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": len(arrays)}, f)
    _barrier()
    return path


def _writer() -> bool:
    """True on the one process that writes: global rank 0, or the only
    process when torch.distributed is not initialised."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def restore_checkpoint(path: str, template):
    """Load a save_checkpoint directory back into `template`'s structure
    (unflatten_into), each leaf cast to the template leaf's dtype."""
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = {key: data[key] for key in data.files}
    return unflatten_into(template, flat)


class CheckpointManager:
    """Step-numbered checkpoints with retention (keep latest N)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            match = re.fullmatch(r"step_(\d+)", name)
            if match:
                steps.append(int(match.group(1)))
        return sorted(steps)

    def save(self, tree, step: int) -> str:
        path = save_checkpoint(self.directory, tree, step)
        if _writer():
            for old in self._steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, f"step_{old}"),
                              ignore_errors=True)
        _barrier()
        return path

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, f"step_{step}")
        return restore_checkpoint(path, template), step
