# The training step: loss → backward → optimizer step, unsharded or on
# a mesh.
#
# Counterpart of aiko_services_tpu/parallel/train.py.  JAX jits the whole
# loss → grad → optax update and lets XLA insert the collectives from
# the shardings; torch runs eagerly, so on a mesh the step spells its
# collectives out:
#   * the batch is sharded over the data axis (each rank takes its
#     slice of the full batch, which every rank passes);
#   * the parameters (and the optimizer's moments, which follow them)
#     are DTensors placed by their logical axes (shard_pytree).  The
#     step hands loss_fn each DTensor's local shard (to_local(), as a
#     fresh leaf that requires grad; a vocabulary chunk short of
#     ceil(V / n) rows, an uneven split's last, padded with zero rows to
#     it, as parallel/sharding.py's serving shards are), so the model
#     computes tensor-parallel: loss_fn calls the model with the mesh
#     (models/whisper.py: column-parallel q / k / v and mlp_in,
#     row-parallel o and mlp_out, the vocab-sharded embedding and head,
#     their sums through collectives' autograd pair) and a
#     vocab-parallel loss (cross_entropy_loss / cross_entropy_sum with
#     the mesh: no rank forms the whole [B, S, V] logits).  Nothing
#     all-gathers a parameter: a rank's activations, gradients and peak
#     memory are its shards'.  The local gradients are summed over the
#     data axis in one flat bucket and become each parameter's gradient
#     as a DTensor of its own placement;
#   * a mesh of one shards nothing: the step is the unsharded one.
# The loss is the global batch's, as JAX's is.  A loss_fn returns either
# a scalar mean over its batch, which the step takes for a mean over
# equal shares (each data rank's share weighs 1/n), or the pair
# (sum, count), e.g. cross_entropy_sum, whose global value
# psum(sum) / max(psum(count), 1) the step forms exactly however the
# counts fall across the shards: a masked loss must return the pair to
# equal JAX's masked mean on a data axis.
#
# optax cannot be imported (it imports JAX), so the optimizers are torch's
# with optax's semantics stated: adamw() is optax.adamw with its defaults
# written out (torch's own weight_decay default, 0.01, is not optax's
# 1e-4), sgd() is optax.sgd.

from __future__ import annotations

from dataclasses import dataclass

import torch

from .collectives import (axis_size, axis_spans, psum, reduce_from_axis,
                          shifted_logsumexp, vocab_offset)
from .sharding import (distribute, named_sharding, pad_chunk, padded_chunk,
                       shard_pytree)

__all__ = ["make_train_step", "cross_entropy_loss", "cross_entropy_sum",
           "TrainState", "init_train_state", "adamw", "sgd"]


class TrainState:
    """Minimal train state: params (an nn.Module) + optimizer state (the
    torch optimizer, whose moments follow the parameters) + step."""

    def __init__(self, params, opt_state, step=0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


@dataclass(frozen=True)
class adamw:
    """optax.adamw(learning_rate) with optax's defaults: b1 0.9, b2
    0.999, eps 1e-8, eps_root 0 and weight decay 1e-4 on every
    parameter.  torch.optim.AdamW orders the update otherwise: it decays
    p by (1 - lr·wd) first, then subtracts lr·m̂/(√v̂ + eps) with the
    bias corrections folded into the step size and the denominator;
    optax adds wd·p to m̂/(√v̂ + eps) and scales the sum by -lr.  Both
    take wd·p from the parameter before the step, so the updates are
    equal as real numbers and differ in f32 by rounding only."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def init(self, params) -> torch.optim.Optimizer:
        if self.eps_root:
            raise ValueError("torch's AdamW has no eps_root")
        return torch.optim.AdamW(
            params.named_parameters(), lr=self.learning_rate,
            betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay, foreach=False)


@dataclass(frozen=True)
class sgd:
    """optax.sgd(learning_rate): p - lr·g, no momentum."""
    learning_rate: float

    def init(self, params) -> torch.optim.Optimizer:
        return torch.optim.SGD(params.named_parameters(),
                               lr=self.learning_rate)


def cross_entropy_loss(logits, targets, mask=None, mesh=None):
    """logits [B,S,V] float32, targets [B,S] int: the mean negative
    log-likelihood over every token, or sum(nll·mask) / max(sum(mask), 1)
    with a mask.  mesh: logits are this rank's vocabulary chunk of a
    model axis, an uneven split's padding columns at -inf (the model's
    forward with the mesh), and the loss is vocab-parallel (_nll), the
    same on every rank."""
    nll = _nll(logits, targets, mesh)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def cross_entropy_sum(logits, targets, mask=None, mesh=None):
    """cross_entropy_loss as the pair (sum of nll·mask, sum of mask), the
    mask all ones when none is given: a loss_fn that returns it gets the
    global batch's masked mean from a train step on a data axis.  mesh:
    as cross_entropy_loss's."""
    nll = _nll(logits, targets, mesh)
    if mask is None:
        return nll.sum(), torch.full((), float(nll.numel()),
                                    device=nll.device)
    mask = mask.to(nll.dtype)
    return (nll * mask).sum(), mask.sum()


def _nll(logits, targets, mesh=None):
    """-log softmax(logits)[target].  On a model axis of more than one
    rank the logits are the rank's vocabulary chunk: the max and the
    sum of exponentials reduce over the axis (shifted_logsumexp), and
    the target's logit comes from the rank whose chunk holds it (a
    masked gather summed through reduce_from_axis, so its gradient
    lands there alone)."""
    if not axis_spans(mesh, "model"):
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        return -log_probs.gather(-1, targets.long()[..., None])[..., 0]
    logits = logits.float()
    top, log_total = shifted_logsumexp(logits, "model", mesh=mesh)
    width = logits.shape[-1]
    local = targets.long() - vocab_offset(width, "model", mesh=mesh)
    inside = (local >= 0) & (local < width)
    picked = logits.gather(-1, torch.where(inside, local, 0)[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    target = reduce_from_axis(picked, "model", mesh=mesh)
    return (top + log_total) - target


def init_train_state(params, optimizer, mesh=None, param_axes=None,
                     rules=None) -> TrainState:
    """Build a TrainState; with a mesh + axes tree the params (and the
    optimizer's moments, which follow them) are placed sharded.  Every
    parameter trains, as every leaf of a JAX param tree does."""
    if mesh is not None and param_axes is not None:
        params = shard_pytree(params, param_axes, mesh, rules)
    for param in params.parameters():
        param.requires_grad_(True)
    return TrainState(params, optimizer.init(params))


def _local_tree(module, mesh):
    """The module's parameters as nested dicts and lists of plain
    tensors: each DTensor's local shard as a fresh leaf that requires
    grad (no communication), a chunk short of its split's ceil(width /
    n) rows padded with zero rows to it (the padding's gradient is
    dropped by the pad's backward); each plain parameter itself.
    Returns (tree, [(param, leaf)])."""
    from torch.distributed.tensor import DTensor, Shard

    from ..models.layers import as_tree

    pairs = []

    def local(node):
        leaf = node.to_local().detach().requires_grad_(True)
        pairs.append((node, leaf))
        view = leaf
        for mesh_dim, placement in enumerate(node.placements):
            if isinstance(placement, Shard):
                dim = placement.dim
                view = pad_chunk(view, dim, padded_chunk(
                    node.shape[dim], mesh.size(mesh_dim)))
        return view

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(value) for key, value in node.items()}
        if isinstance(node, list):
            return [walk(value) for value in node]
        if isinstance(node, DTensor):
            return local(node)
        return node
    return walk(as_tree(module)), pairs


def _share(terms, data, mesh):
    """This rank's share of the global loss from loss_fn's result: the
    shares sum over the data axis to the global batch's loss."""
    if isinstance(terms, tuple):
        total, count = terms
        count = count.detach().float()
        if data is not None:
            count = psum(count, data, mesh=mesh)
        return total / torch.clamp(count, min=1.0)
    if data is not None:
        return terms / axis_size(data, mesh=mesh)
    return terms


def make_train_step(loss_fn, mesh=None, batch_axes=("batch",), rules=None):
    """Build a full train step.

    loss_fn(params, batch) -> a scalar mean loss, or the pair (sum,
    count) (cross_entropy_sum).  Returns step(state, batch) -> (state,
    loss): loss → backward → state.opt_state's step, in place (the
    parameters and moments update where they live, as JAX's donation
    lets them), and state.step counts.  With a mesh, the batch (a dict
    of full tensors) is sharded over the data axis, loss_fn is handed
    the parameters' local shards (the module's header), and the step
    runs the collectives the header describes: loss_fn then calls the
    model and the loss with the mesh."""
    sharded = mesh is not None and mesh.size() > 1
    if sharded:
        from torch.distributed.tensor import DTensor

    def step(state, batch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        if not sharded:
            loss = _share(loss_fn(state.params, batch), None, None)
            loss.backward()
            opt.step()
            state.step += 1
            return state, loss.detach()
        local = {key: distribute(x, named_sharding(
            mesh, *batch_axes[:x.ndim], rules=rules)).to_local()
            for key, x in batch.items()}
        tree, pairs = _local_tree(state.params, mesh)
        data = "data" if "data" in mesh.mesh_dim_names else None
        loss = _share(loss_fn(tree, local), data, mesh)
        loss.backward()
        localised = {id(param) for param, _ in pairs}
        pairs += [(param, param) for param in state.params.parameters()
                  if id(param) not in localised and param.grad is not None]
        grads = [leaf.grad if leaf.grad is not None else
                 torch.zeros_like(leaf) for _, leaf in pairs]
        if data is not None:        # one all-reduce for every gradient
            bucket = psum(torch.cat([g.reshape(-1).float() for g in grads]),
                          data, mesh=mesh)
            grads = [chunk.view(g.shape).to(g.dtype) for chunk, g in zip(
                bucket.split([g.numel() for g in grads]), grads)]
        for (param, leaf), grad in zip(pairs, grads):
            if param is not leaf:
                grad = DTensor.from_local(grad, mesh, param.placements,
                                          run_check=False,
                                          shape=param.shape,
                                          stride=param.stride())
            param.grad = grad
        opt.step()
        loss = loss.detach()
        if data is not None:
            loss = psum(loss, data, mesh=mesh)
        state.step += 1
        return state, loss

    return step
