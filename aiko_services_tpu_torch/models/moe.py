# Mixture-of-experts FFN in PyTorch: top-k routing with a static
# capacity per expert.
#
# Counterpart of aiko_services_tpu/models/moe.py, with its routing and
# its drops: capacity = max(1, int(cf * n * top_k / e)) over every row
# the call receives (padding rows and idle slots included), queue
# positions by a cumsum over the flattened [N * K, E] assignment
# (token-major), and an assignment past its expert's capacity dropped
# (the residual path still carries the token).  Where torch differs:
#   - jax.lax.top_k breaks ties toward the lowest index; torch.topk
#     promises no order, so the experts come from a stable descending
#     sort (rows of equal logits pick experts 0, 1, ...);
#   - the reference's one-hot dispatch and combine einsums sum one
#     non-zero term per expert slot, so they are a scatter into and a
#     gather out of the [E * C, D] expert batch here, exact in any
#     order; a dropped assignment goes to a trash row past the batch
#     (no boolean selection, which would wait for the card);
#   - each expert product accumulates in f32 (a bf16-in / f32-out
#     product on the card, f32 operands elsewhere) and the activation,
#     jax.nn.gelu's default tanh form, runs on the f32 sums before the
#     cast back to the token dtype, as preferred_element_type does.
#
# Expert parallelism (a mesh with an expert axis): every rank routes the
# same rows through the replicated router, so top-k, queue positions,
# capacity (JAX's global one, over every expert) and drops are the
# unsharded layer's on every rank; each rank scatters only the
# assignments of its own contiguous run of experts, runs them, and the
# weighted combine of its kept assignments is summed over the expert
# axis in f32 (and over the model axis too when ffn is sharded there:
# each expert's product is then a partial sum).  A sum of one or two
# non-zero terms and zeros is exact in any order, so an expert-sharded
# layer gives the unsharded layer's bits.

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device, torch_dtype
from . import layers as L

__all__ = ["MoeConfig", "MoE", "moe_init", "moe_axes", "moe_forward",
           "drop_counts"]

# when a list, each moe_forward call appends its count of dropped
# assignments as a device tensor (no host wait); None records nothing
drop_counts: list | None = None


@dataclass(frozen=True)
class MoeConfig:
    """The JAX MoeConfig field for field."""
    dim: int = 64
    ffn_dim: int = 128
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))


class MoE(L.Params):
    """Router (no bias) and expert weights w_in [E, D, F], w_out
    [E, F, D], named as the JAX param tree."""

    def __init__(self, config: MoeConfig, device=None):
        super().__init__()
        e, d, f, dtype = (config.num_experts, config.dim, config.ffn_dim,
                          config.dtype)
        self.router = L.Linear(d, e, False, dtype, device)
        self.w_in = L._param((e, d, f), dtype, device)
        self.w_out = L._param((e, f, d), dtype, device)

    @torch.no_grad()
    def init_(self, generator) -> None:
        L._normal_(self.w_in, generator, 1.0 / math.sqrt(self.w_in.shape[1]))
        L._normal_(self.w_out, generator,
                   1.0 / math.sqrt(self.w_out.shape[1]))


@torch.no_grad()
def moe_init(generator: torch.Generator, config: MoeConfig,
             device=None) -> MoE:
    """An MoE FFN with random weights drawn from `generator` (the JAX
    package's distributions; its numbers differ, as torch and jax random
    streams do).  device=None means the CUDA card."""
    moe = MoE(config, device=resolve_device(device))
    for module in moe.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    return moe


def moe_axes():
    return {
        "router": L.linear_axes("embed", None, bias=False),
        "w_in": ("expert", "embed", "ffn"),
        "w_out": ("expert", "ffn", "embed"),
    }


def _bmm_f32(a, b):
    """Batched a @ b summed in f32: one bf16-in / f32-out product on the
    card, f32 operands elsewhere (the CPU has no such product)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _expert_axes(mesh) -> list:
    """The mesh axes an expert's output is partial over: expert (each
    rank holds some experts) and model (ffn sharded inside each expert),
    those that span more than one rank."""
    if mesh is None:
        return []
    from ..parallel.collectives import axis_spans
    return [axis for axis in ("expert", "model") if axis_spans(mesh, axis)]


def moe_forward(params, config: MoeConfig, x, mesh=None):
    """x: [B, S, D] → (y [B, S, D], aux_loss scalar f32).  Top-k routing
    with capacity C per expert; aux_loss is the Switch-style balance term
    (fraction of top-1 choices kept by each expert × its mean router
    probability, summed, × E).  mesh: params hold this rank's experts
    (w_in / w_out [E / n, ...], the router whole) and config their
    count; routing and capacity are over all E experts."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    k = config.top_k
    n, e = b * s, params["router"]["w"].shape[-1]
    capacity = max(1, int(config.capacity_factor * n * k / e))
    partial = _expert_axes(mesh)
    local_e = params["w_in"].shape[0]
    first = 0
    if "expert" in partial:
        from ..parallel.collectives import axis_index
        first = axis_index("expert", mesh=mesh) * local_e

    router_logits = torch.matmul(tokens.float(),
                                 params["router"]["w"].float())   # [N, E]
    probs = torch.softmax(router_logits, dim=-1)
    top_probs, top_experts = torch.sort(probs, dim=-1, descending=True,
                                        stable=True)
    top_probs, top_experts = top_probs[:, :k], top_experts[:, :k]  # [N, K]

    # each assignment's position in its expert's queue: the count of
    # earlier assignments (token-major, then k) to the same expert
    one_hot = F.one_hot(top_experts, e)                         # [N, K, E]
    flat_assign = one_hot.reshape(n * k, e)
    position = torch.cumsum(flat_assign, dim=0) - flat_assign
    position = (position.reshape(n, k, e) * one_hot).sum(-1)    # [N, K]
    keep = position < capacity
    if drop_counts is not None:
        drop_counts.append((~keep).sum())

    # scatter into the expert batch [E_local * C (+ 1 trash row), D]:
    # this rank's experts [first, first + E_local); the others' and the
    # dropped assignments go to the trash row
    mine = keep & (top_experts >= first) & (top_experts < first + local_e)
    trash = local_e * capacity
    slots = torch.where(mine, (top_experts - first) * capacity + position,
                        torch.full_like(position, trash)).reshape(-1)
    expert_in = tokens.new_zeros((trash + 1, d))
    expert_in[slots] = tokens.repeat_interleave(k, dim=0)
    expert_in = expert_in[:trash].reshape(local_e, capacity, d)
    # with ffn sharded over model each rank holds a slice of the hidden
    # units (gelu acts on each alone), so only the output is partial
    hidden = F.gelu(_bmm_f32(expert_in, params["w_in"]),
                    approximate="tanh").to(tokens.dtype)
    expert_out = _bmm_f32(hidden, params["w_out"])
    if "model" in partial:
        from ..parallel.collectives import psum_
        expert_out = psum_(expert_out, "model", mesh=mesh)
    expert_out = expert_out.to(tokens.dtype)

    # combine: Σ_k bf16(p_k) · out[e_k, c_k] in f32, dropped terms 0
    rows = torch.cat([expert_out.reshape(trash, d),
                      expert_out.new_zeros((1, d))])[slots]
    weights = top_probs.to(tokens.dtype).float() * mine
    y = (weights.reshape(n, k, 1) * rows.reshape(n, k, d).float()).sum(1)
    if "expert" in partial:
        from ..parallel.collectives import psum_
        y = psum_(y, "expert", mesh=mesh)
    y = y.to(tokens.dtype)

    routed_fraction = (one_hot[:, 0] * keep[:, 0:1]).float().mean(dim=0)
    aux_loss = e * torch.sum(routed_fraction * probs.mean(dim=0))
    return y.reshape(b, s, d), aux_loss
