# Llama-style decoder-only transformer in PyTorch.
#
# Counterpart of aiko_services_tpu/models/llama.py: GQA attention with
# interleaved-pair RoPE, RMSNorm, a dense SwiGLU FFN and an untied
# lm_head.  The Llama module's parameter names are the JAX param tree's
# paths joined by '.' (layers.3.attn.q.w ↔ layers/3/attn/q/w), so
# bridge.py copies a JAX tree in by name.  The mixture-of-experts FFN
# (num_experts > 0) and the sequence-parallel forward are not ported yet
# (ROADMAP.md Queue 1 items 5 and 10).

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from . import layers as L

__all__ = ["LlamaConfig", "Llama", "llama_init", "llama_hidden",
           "llama_decode_step", "llama_forward", "llama_greedy_decode",
           "llama_ffn", "init_llama_caches", "LLAMA_PRESETS"]


@dataclass(frozen=True)
class LlamaConfig:
    """The JAX LlamaConfig field for field (num_experts / top_k describe
    the MoE geometry, which raises until models/moe.py is ported)."""
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

    def __post_init__(self):
        # accept the JAX config's spellings (jnp.bfloat16, "float32", ...)
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def head_dim(self):
        return self.dim // self.num_heads


LLAMA_PRESETS = {
    # llama-3-8b geometry
    "8b": LlamaConfig(),
    # scaled-down variants for tests / CI / single-card smoke
    "tiny": LlamaConfig(vocab=256, dim=64, ffn_dim=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=128),
    # Llama-3.2-1B's widths
    "1b": LlamaConfig(vocab=128256, dim=2048, ffn_dim=8192, num_layers=16,
                      num_heads=32, num_kv_heads=8),
}


def _dense_only(config: LlamaConfig) -> None:
    if config.num_experts:
        raise NotImplementedError(
            "the mixture-of-experts FFN (num_experts > 0) is not ported "
            "yet (ROADMAP.md Queue 1 item 5)")


class LlamaLayer(L.Params):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        _dense_only(config)
        dim, dtype = config.dim, config.dtype
        self.ln_attn = L.RMSNorm(dim, dtype, device)
        self.attn = L.MHA(dim, config.num_heads, config.num_kv_heads,
                          bias=False, dtype=dtype, device=device)
        self.ln_mlp = L.RMSNorm(dim, dtype, device)
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


def init_llama_caches(config: LlamaConfig, batch: int,
                      max_len: int | None = None, device=None):
    device = resolve_device(device)
    return [L.init_kv_cache(batch, max_len or config.max_seq_len,
                            config.num_kv_heads, config.head_dim,
                            config.dtype, device)
            for _ in range(config.num_layers)]


def _attention(layer, config: LlamaConfig, x, cos, sin, cache,
               position_offset, mask):
    """RoPE attention with GQA + KV cache: layers.mha with the rotation
    injected via qk_transform, so cached keys are stored
    already-positioned."""
    def rope(q, k):
        return (L.apply_rope(q, cos, sin, position_offset),
                L.apply_rope(k, cos, sin, position_offset))

    return L.mha(layer["attn"], x, mask=mask, cache=cache,
                 num_heads=config.num_heads,
                 num_kv_heads=config.num_kv_heads, qk_transform=rope)


def _swiglu(layer, x):
    return L.linear(layer["down"],
                    torch.nn.functional.silu(L.linear(layer["gate"], x)) *
                    L.linear(layer["up"], x))


def llama_ffn(layer, config: LlamaConfig, x):
    """The per-layer FFN: dense SwiGLU (the MoE variant raises)."""
    _dense_only(config)
    return _swiglu(layer, x)


def llama_hidden(params, config: LlamaConfig, tokens, caches,
                 position_offset=0):
    """tokens: [B, T] → (final hidden states [B, T, dim], caches).  T=1
    for incremental decode; T>1 prefills with an in-step causal mask.
    The caches update in place (layers.update_kv_cache)."""
    device = tokens.device
    cos, sin = L.rope_frequencies(config.head_dim, config.max_seq_len,
                                  config.rope_theta, device=device)
    x = L.embedding(params["embed"], tokens).to(config.dtype)
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
            cache, position_offset, mask)
        x = x + attn_out
        x = x + llama_ffn(layer, config, L.rms_norm(layer["ln_mlp"], x))
        new_caches.append(cache)
    return L.rms_norm(params["ln_out"], x), new_caches


def llama_decode_step(params, config: LlamaConfig, tokens, caches,
                      position_offset=0):
    """tokens: [B, T] → (logits [B, T, vocab] f32, caches).  The head
    runs on the f32 hidden states with f32 accumulation (the JAX code's
    linear(lm_head, x.astype(f32)); without a bias that is
    linear_logits' product)."""
    x, new_caches = llama_hidden(params, config, tokens, caches,
                                 position_offset)
    return L.linear_logits(params["lm_head"], x.float()), new_caches


def llama_forward(params, config: LlamaConfig, tokens):
    """Teacher-forced full-sequence forward: tokens [B, S] → logits."""
    caches = init_llama_caches(config, tokens.shape[0], tokens.shape[1],
                               device=tokens.device)
    logits, _ = llama_decode_step(params, config, tokens, caches)
    return logits


@torch.inference_mode()
def llama_greedy_decode(params, config: LlamaConfig, prompt,
                        max_tokens: int = 32, eos_token: int | None = None):
    """prompt: [B, S] → generated tokens [B, max_tokens] int32: a prefill,
    then one decode step per token over a dense static-shape cache (the
    JAX lax.scan as a Python loop).  Finished rows keep emitting EOS."""
    batch, prompt_len = prompt.shape
    caches = init_llama_caches(config, batch, prompt_len + max_tokens,
                               device=prompt.device)
    logits, caches = llama_decode_step(params, config, prompt, caches)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    eos = eos_token if eos_token is not None else -1
    done = token == eos
    emitted = []
    for step in range(max_tokens):
        emitted.append(token)
        logits, caches = llama_decode_step(
            params, config, token[:, None], caches,
            position_offset=prompt_len + step)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        token = torch.where(done, torch.full_like(next_token, eos),
                            next_token)
        done = done | (token == eos)
    return torch.stack(emitted, dim=1)
