# Llama-style decoder-only transformer in PyTorch.
#
# Counterpart of aiko_services_tpu/models/llama.py: GQA attention with
# interleaved-pair RoPE, RMSNorm, a dense SwiGLU FFN or (num_experts > 0)
# a top-k mixture-of-experts FFN (models/moe.py), and an untied lm_head.
# The Llama module's parameter names are the JAX param tree's paths
# joined by '.' (layers.3.attn.q.w ↔ layers/3/attn/q/w, layers.3.moe.w_in
# ↔ layers/3/moe/w_in), so bridge.py copies a JAX tree in by name.
# llama_forward_sp is the sequence-parallel prefill: each rank of a mesh's
# "seq" axis holds S/n tokens and attends through ring attention.
#
# Tensor and expert parallelism (sharded serving): with a mesh, the
# functions below take this rank's shards (parallel.sharding.local_shards)
# and its rank-local config (local_config: heads, KV heads, ffn and vocab
# divided over the model axis, experts over the expert axis).  q/k/v and
# gate/up are column-parallel and need nothing; o and down are
# row-parallel, each followed by a sum over the model axis
# (layers.row_parallel_linear); the embedding and the head are
# vocab-sharded (layers.embedding, layers.linear_logits); the MoE FFN
# runs the rank's experts and sums over the expert axis
# (moe.moe_forward).  With mesh=None, or a mesh whose axes are one rank,
# nothing changes: the same launches and the same numbers.

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from . import layers as L

__all__ = ["LlamaConfig", "Llama", "llama_init", "llama_axes",
           "llama_hidden", "llama_decode_step", "llama_forward",
           "llama_forward_sp", "llama_greedy_decode",
           "llama_ffn", "init_llama_caches", "llama_rank_budget",
           "LLAMA_PRESETS"]


@dataclass(frozen=True)
class LlamaConfig:
    """The JAX LlamaConfig field for field (num_experts > 0 swaps the
    dense SwiGLU FFN for a top-k MoE layer)."""
    vocab: int = 128256
    dim: int = 4096
    ffn_dim: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.float32
    num_experts: int = 0
    top_k: int = 2
    # the port's one field more: a rank-local config (local_config) holds
    # this rank's num_heads, and head_shards their divisor, so head_dim
    # stays the model's; 1 for a model's own config
    head_shards: int = 1

    def __post_init__(self):
        # accept the JAX config's spellings (jnp.bfloat16, "float32", ...)
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def head_dim(self):
        return self.dim // (self.num_heads * self.head_shards)

    def moe_config(self):
        from .moe import MoeConfig
        return MoeConfig(dim=self.dim, ffn_dim=self.ffn_dim,
                         num_experts=self.num_experts, top_k=self.top_k,
                         dtype=self.dtype)


LLAMA_PRESETS = {
    # llama-3-8b geometry
    "8b": LlamaConfig(),
    # scaled-down variants for tests / CI / single-card smoke
    "tiny": LlamaConfig(vocab=256, dim=64, ffn_dim=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=128),
    # Llama-3.2-1B's widths
    "1b": LlamaConfig(vocab=128256, dim=2048, ffn_dim=8192, num_layers=16,
                      num_heads=32, num_kv_heads=8),
    # MoE variants (Mixtral-style FFN): tiny for tests, 8x1b the
    # serving-scale geometry (Llama-1B's widths, 8 experts, top 2)
    "tiny_moe": LlamaConfig(vocab=256, dim=64, ffn_dim=128, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=128,
                            num_experts=4, top_k=2),
    "8x1b": LlamaConfig(vocab=128256, dim=2048, ffn_dim=8192,
                        num_layers=16, num_heads=32, num_kv_heads=8,
                        num_experts=8, top_k=2),
}


class LlamaLayer(L.Params):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dim, dtype = config.dim, config.dtype
        self.ln_attn = L.RMSNorm(dim, dtype, device)
        self.attn = L.MHA(dim, config.num_heads, config.num_kv_heads,
                          bias=False, dtype=dtype, device=device)
        self.ln_mlp = L.RMSNorm(dim, dtype, device)
        if config.num_experts:
            from .moe import MoE
            self.moe = MoE(config.moe_config(), device)
        else:
            self.gate = L.Linear(dim, config.ffn_dim, False, dtype, device)
            self.up = L.Linear(dim, config.ffn_dim, False, dtype, device)
            self.down = L.Linear(config.ffn_dim, dim, False, dtype, device)


class Llama(L.Params):
    """Llama's parameters, uninitialised (llama_init fills them from a
    generator; bridge.py copies a JAX param tree in)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        dim, dtype = config.dim, config.dtype
        self.embed = L.Embedding(config.vocab, dim, dtype, device)
        self.layers = nn.ModuleList(LlamaLayer(config, device)
                                    for _ in range(config.num_layers))
        self.ln_out = L.RMSNorm(dim, dtype, device)
        self.lm_head = L.Linear(dim, config.vocab, False, dtype, device)


@torch.no_grad()
def llama_init(generator: torch.Generator, config: LlamaConfig,
               device=None) -> Llama:
    """A Llama with random weights drawn from `generator` (the JAX
    package's distributions; its numbers differ, as torch and jax random
    streams do).  device=None means the CUDA card."""
    model = Llama(config, device=resolve_device(device))
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    return model


def _layer_axes(config: LlamaConfig | None = None):
    axes = {
        "ln_attn": L.rms_norm_axes(),
        "attn": L.mha_axes(bias=False),
        "ln_mlp": L.rms_norm_axes(),
    }
    if config is not None and config.num_experts:
        from .moe import moe_axes
        axes["moe"] = moe_axes()
    else:
        axes |= {
            "gate": L.linear_axes("embed", "ffn", bias=False),
            "up": L.linear_axes("embed", "ffn", bias=False),
            "down": L.linear_axes("ffn", "embed", bias=False),
        }
    return axes


def llama_axes(config: LlamaConfig):
    """Each parameter's logical axes, shaped like the JAX param tree."""
    return {
        "embed": L.embedding_axes(),
        "layers": [_layer_axes(config)] * config.num_layers,
        "ln_out": L.rms_norm_axes(),
        "lm_head": L.linear_axes("embed", "vocab", bias=False),
    }


def llama_rank_budget(config: LlamaConfig, mesh_axes: dict, slots: int,
                      positions: int, rules=None) -> dict:
    """One rank's device bytes for serving `config` sharded over a mesh
    of `mesh_axes` sizes (e.g. {"model": 8}): {"weight_bytes": this
    rank's shards of every parameter, "kv_bytes": K and V of every layer
    for `slots` slots of `positions` positions at its KV heads}.  The
    tree is built on the meta device, so no weight is materialised and
    no process group is needed; a dimension whose logical axis maps to
    a mesh axis counts its share (local_config's widths).  The port's
    counterpart of the JAX package's 8B agent plan arithmetic."""
    from ..parallel.sharding import DEFAULT_RULES, _axes_at
    rules = rules or DEFAULT_RULES
    model = Llama(config, device="meta")
    axes_tree = llama_axes(config)
    weight_bytes = 0
    for path, leaf in L.tree_leaves(model):
        numel = leaf.numel()
        for size, logical in zip(leaf.shape,
                                 _axes_at(axes_tree, list(path)) or ()):
            share = mesh_axes.get(rules.rules.get(logical), 1)
            if size % share:
                raise ValueError(f"{'.'.join(map(str, path))}: {size} "
                                 f"does not divide over {share} ranks")
            numel //= share
        weight_bytes += numel * leaf.element_size()
    kv_share = mesh_axes.get(rules.rules.get("kv_heads"), 1)
    if config.num_kv_heads % kv_share:
        raise ValueError(f"num_kv_heads {config.num_kv_heads} does not "
                         f"divide over {kv_share} ranks")
    itemsize = torch.empty((), dtype=config.dtype).element_size()
    kv_bytes = (2 * config.num_layers * slots *
                (config.num_kv_heads // kv_share) * positions *
                config.head_dim * itemsize)
    return {"weight_bytes": weight_bytes, "kv_bytes": kv_bytes}


def init_llama_caches(config: LlamaConfig, batch: int,
                      max_len: int | None = None, device=None):
    device = resolve_device(device)
    return [L.init_kv_cache(batch, max_len or config.max_seq_len,
                            config.num_kv_heads, config.head_dim,
                            config.dtype, device)
            for _ in range(config.num_layers)]


def _attention(layer, config: LlamaConfig, x, cos, sin, cache,
               position_offset, mask, mesh=None):
    """RoPE attention with GQA + KV cache: layers.cached_mha with the
    rotation injected via qk_transform, so cached keys are stored
    already-positioned.  mesh: the config's heads are this rank's and o
    is row-parallel."""
    def rope(q, k):
        return (L.apply_rope(q, cos, sin, position_offset),
                L.apply_rope(k, cos, sin, position_offset))

    return L.cached_mha(layer["attn"], x, cache, mask=mask,
                        num_heads=config.num_heads,
                        num_kv_heads=config.num_kv_heads,
                        qk_transform=rope, mesh=mesh)


def _swiglu(layer, x, mesh=None):
    if "gate_up" in layer:
        # the fused serving form (fuse_projections): one [dim, 2*ffn]
        # product, split after
        gate_up = L.linear(layer["gate_up"], x)
        ffn = gate_up.shape[-1] // 2
        return L.row_parallel_linear(
            layer["down"], torch.nn.functional.silu(gate_up[..., :ffn]) *
            gate_up[..., ffn:], mesh)
    return L.row_parallel_linear(
        layer["down"],
        torch.nn.functional.silu(L.linear(layer["gate"], x)) *
        L.linear(layer["up"], x), mesh)


def llama_ffn(layer, config: LlamaConfig, x, mesh=None):
    """The per-layer FFN: dense SwiGLU, or top-k MoE when the config says
    so.  The one seam of prefill, admits, extends, decode and verify
    steps: an MoE model serves through the same programs, and each call
    routes (and drops) over exactly the rows it is given.  mesh: the
    dense FFN's down is row-parallel over the model axis; the MoE runs
    this rank's experts."""
    if config.num_experts:
        from .moe import moe_forward
        y, _ = moe_forward(layer["moe"], config.moe_config(), x, mesh=mesh)
        return y
    return _swiglu(layer, x, mesh)


def llama_hidden(params, config: LlamaConfig, tokens, caches,
                 position_offset=0, mesh=None):
    """tokens: [B, T] → (final hidden states [B, T, dim], caches).  T=1
    for incremental decode; T>1 prefills with an in-step causal mask.
    The caches update in place (layers.update_kv_cache).  mesh: the
    params are this rank's shards and config its rank-local config (the
    caches hold its KV heads)."""
    device = tokens.device
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)
    x = L.embedding(params["embed"], tokens, mesh).to(config.dtype)
    t = tokens.shape[1]

    mask = None
    if t > 1:
        q_pos = position_offset + torch.arange(t, device=device)[:, None]
        k_pos = torch.arange(caches[0]["k"].shape[2], device=device)[None]
        mask = (k_pos <= q_pos)[None, None]

    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        attn_out, cache = _attention(
            layer, config, L.rms_norm(layer["ln_attn"], x), cos, sin,
            cache, position_offset, mask, mesh)
        x = x + attn_out
        x = x + llama_ffn(layer, config, L.rms_norm(layer["ln_mlp"], x),
                          mesh)
        new_caches.append(cache)
    return L.rms_norm(params["ln_out"], x), new_caches


def llama_decode_step(params, config: LlamaConfig, tokens, caches,
                      position_offset=0, mesh=None):
    """tokens: [B, T] → (logits [B, T, vocab] f32, caches).  The head
    runs on the f32 hidden states with f32 accumulation (the JAX code's
    linear(lm_head, x.astype(f32)); without a bias that is
    linear_logits' product).  mesh: the logits of the whole vocabulary,
    gathered over the model axis."""
    x, new_caches = llama_hidden(params, config, tokens, caches,
                                 position_offset, mesh)
    return L.linear_logits(params["lm_head"], x.float(), mesh), new_caches


def llama_forward(params, config: LlamaConfig, tokens, mesh=None):
    """Teacher-forced full-sequence forward: tokens [B, S] → logits."""
    caches = init_llama_caches(config, tokens.shape[0], tokens.shape[1],
                               device=tokens.device)
    logits, _ = llama_decode_step(params, config, tokens, caches, mesh=mesh)
    return logits


def llama_forward_sp(params, config: LlamaConfig, tokens, mesh,
                     axis_name: str = "seq", batch_axis: str = "data"):
    """Sequence-parallel long-context forward (prefill): activations
    sharded over the sequence axis of `mesh`, exact causal attention by
    ring attention (K/V blocks rotate, online softmax), so each rank
    holds S/n of the sequence and no rank holds the S x S scores.

    tokens: [B, S] (a full tensor every rank holds, or a DTensor) with S
    divisible by the axis size; the parameters are replicated (every
    rank holds them whole).  Returns logits [B, S, vocab] f32 as a
    DTensor sharded the same way."""
    from ..parallel.collectives import axis_index, shard_map
    from ..parallel.ring_attention import ring_attention_sharded

    def body(tokens_local):
        cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                      config.rope_theta,
                                      device=tokens_local.device)
        offset = axis_index(axis_name, mesh=mesh) * tokens_local.shape[1]
        x = L.embedding(params["embed"], tokens_local).to(config.dtype)
        for layer in params["layers"]:
            attn = layer["attn"]
            normed = L.rms_norm(layer["ln_attn"], x)
            q = L._split_heads(L.linear(attn["q"], normed), config.num_heads)
            k = L._split_heads(L.linear(attn["k"], normed),
                               config.num_kv_heads)
            v = L._split_heads(L.linear(attn["v"], normed),
                               config.num_kv_heads)
            q = L.apply_rope(q, cos, sin, offset)
            k = L.apply_rope(k, cos, sin, offset)
            # K/V stay at num_kv_heads: the ring rotates the small
            # blocks and expands them per block
            out = ring_attention_sharded(q, k, v, axis_name=axis_name,
                                         causal=True, mesh=mesh)
            x = x + L.linear(attn["o"], L._merge_heads(out))
            x = x + llama_ffn(layer, config,
                              L.rms_norm(layer["ln_mlp"], x))
        x = L.rms_norm(params["ln_out"], x)
        return L.linear_logits(params["lm_head"], x.float())

    batch = batch_axis if batch_axis in mesh.mesh_dim_names else None
    return shard_map(body, mesh, ((batch, axis_name),),
                     (batch, axis_name, None))(tokens)


@torch.inference_mode()
def llama_greedy_decode(params, config: LlamaConfig, prompt,
                        max_tokens: int = 32, eos_token: int | None = None,
                        mesh=None):
    """prompt: [B, S] → generated tokens [B, max_tokens] int32: a prefill,
    then one decode step per token over a dense static-shape cache (the
    JAX lax.scan as a Python loop).  Finished rows keep emitting EOS.
    mesh: rank-local params and config; every rank returns the same
    tokens."""
    batch, prompt_len = prompt.shape
    caches = init_llama_caches(config, batch, prompt_len + max_tokens,
                               device=prompt.device)
    logits, caches = llama_decode_step(params, config, prompt, caches,
                                       mesh=mesh)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    eos = eos_token if eos_token is not None else -1
    done = token == eos
    emitted = []
    for step in range(max_tokens):
        emitted.append(token)
        logits, caches = llama_decode_step(
            params, config, token[:, None], caches,
            position_offset=prompt_len + step, mesh=mesh)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        token = torch.where(done, torch.full_like(next_token, eos),
                            next_token)
        done = done | (token == eos)
    return torch.stack(emitted, dim=1)
