# Neural text-to-speech in PyTorch: a compact FastSpeech-style acoustic
# model and the Griffin-Lim leg of ops/audio.py.
#
# Counterpart of aiko_services_tpu/models/tts.py: byte tokens → a
# transformer encoder → a learned per-token log-duration head → static
# length regulation → log-mel frames; mel → waveform is mel_to_linear +
# griffin_lim, or the neural vocoder (models/vocoder.py) when its weights
# are given.  The TTS module's parameter names are the JAX param tree's
# paths joined by '.' (blocks.1.attn.q.w ↔ blocks/1/attn/q/w), so
# bridge.py and the flat-npz scheme copy a JAX checkpoint in by name.
#
# Length regulation keeps the reference's arithmetic: ends = cumsum(d)
# and starts = ends - d (not an exclusive cumsum), frame t owned by the
# token with starts <= t < ends on f32 frame indices, gathered by a
# [T, S] one-hot product; the voiced length is ceil(total) frames clipped
# to [0, max_frames], times the hop.
#
# Tensor parallelism (mesh=): the model is placed by tts_axes, as JAX
# places it (ComputeRuntime.place_params): the byte embedding is cut
# into vocabulary chunks, attention runs on the rank's heads with its o
# projection row-parallel, mlp_in is column-parallel over "ffn" and
# mlp_out row-parallel; mel_head and dur_head stay whole, so every rank
# regulates and synthesizes the same frames (Griffin-Lim and the
# vocoder run whole on every rank).  With mesh=None, or a one-rank
# model axis, the path is the unsharded one.
#
# predict_durations and tts_forward are differentiable, as JAX's are
# (the golden trainers, tests/torch_golden.py, take gradients through
# them); they build no graph unless a parameter requires grad.

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from . import layers as L

__all__ = ["TTSConfig", "TTS", "TTS_PRESETS", "tts_init", "tts_axes",
           "local_heads", "tts_forward",
           "predict_durations", "regulate", "synthesize"]


@dataclass(frozen=True)
class TTSConfig:
    """The JAX TTSConfig field for field."""
    vocab: int = 256              # byte-level input
    dim: int = 128
    num_layers: int = 4
    num_heads: int = 4
    n_mels: int = 80
    frames_per_token: int = 8     # duration prior (mean log-d bias)
    max_tokens: int = 128
    max_frames: int = 1024        # static regulator output length
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))


TTS_PRESETS = {
    "test": TTSConfig(dim=64, num_layers=2, num_heads=4,
                      frames_per_token=6, max_tokens=32, max_frames=96),
    "base": TTSConfig(),
}


class TTSBlock(L.Params):
    def __init__(self, config: TTSConfig, device=None):
        super().__init__()
        dim, dtype = config.dim, config.dtype
        self.ln_attn = L.LayerNorm(dim, dtype, device)
        self.attn = L.MHA(dim, config.num_heads, dtype=dtype, device=device)
        self.ln_mlp = L.LayerNorm(dim, dtype, device)
        self.mlp_in = L.Linear(dim, dim * 4, True, dtype, device)
        self.mlp_out = L.Linear(dim * 4, dim, True, dtype, device)


class TTS(L.Params):
    """The acoustic model's parameters, uninitialised (tts_init fills
    them from a generator; bridge.py copies a JAX param tree in)."""

    def __init__(self, config: TTSConfig, device=None):
        super().__init__()
        self.config = config
        dim, dtype = config.dim, config.dtype
        self.embed = L.Embedding(config.vocab, dim, dtype, device)
        self.blocks = nn.ModuleList(TTSBlock(config, device)
                                    for _ in range(config.num_layers))
        self.ln_out = L.LayerNorm(dim, dtype, device)
        self.mel_head = L.Linear(dim, config.n_mels, True, dtype, device)
        # log-duration per token (FastSpeech-style, trained supervised
        # against ground-truth alignments)
        self.dur_head = L.Linear(dim, 1, True, dtype, device)


@torch.no_grad()
def tts_init(generator: torch.Generator, config: TTSConfig,
             device=None) -> TTS:
    """A TTS with random weights drawn from `generator` (the JAX
    package's distributions; its numbers differ, as torch and jax random
    streams do).  device=None means the CUDA card."""
    model = TTS(config, device=resolve_device(device))
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    return model


def _block_axes():
    return {
        "ln_attn": L.layer_norm_axes(),
        "attn": L.mha_axes(),
        "ln_mlp": L.layer_norm_axes(),
        "mlp_in": L.linear_axes("embed", "ffn"),
        "mlp_out": L.linear_axes("ffn", "embed"),
    }


def tts_axes(config: TTSConfig):
    return {
        "embed": L.embedding_axes(),
        "blocks": [_block_axes()] * config.num_layers,
        "ln_out": L.layer_norm_axes(),
        "mel_head": L.linear_axes("embed", None),
        "dur_head": L.linear_axes("embed", None),
    }


def local_heads(config: TTSConfig, mesh=None) -> int:
    """This rank's attention heads: the config's over the size of the
    model axis; all of them without a mesh.  Heads that do not divide
    raise ValueError, as JAX's placement does."""
    return L.model_share(config.num_heads, "num_heads", mesh)


def _encode(params, config: TTSConfig, tokens, mesh=None):
    x = L.embedding(params["embed"], tokens, mesh).to(config.dtype)
    positions = L.sinusoid_position_encoding(tokens.shape[1], config.dim,
                                             device=tokens.device)
    x = x + positions[None].to(x.dtype)
    heads = local_heads(config, mesh)
    for block in params["blocks"]:
        attn_out, _ = L.mha(block["attn"],
                            L.layer_norm(block["ln_attn"], x),
                            num_heads=heads, mesh=mesh)
        x = x + attn_out
        hidden = L.linear(block["mlp_in"], L.enter_columns(
            L.layer_norm(block["ln_mlp"], x), mesh))
        x = x + L.row_parallel_linear(block["mlp_out"], L.gelu(hidden),
                                      mesh)
    return L.layer_norm(params["ln_out"], x)


def _durations_from_hidden(params, config: TTSConfig, tokens, hidden):
    """(log-durations [B, S], durations [B, S] with pad tokens at 0); the
    frames_per_token prior is the head's log bias."""
    log_d = L.linear(params["dur_head"], hidden)[..., 0] + \
        math.log(float(config.frames_per_token))
    return log_d, torch.where(tokens > 0, torch.exp(log_d),
                              torch.zeros_like(log_d))


def predict_durations(params, config: TTSConfig, tokens, mesh=None):
    """tokens [B, S] → (log-durations, durations)."""
    hidden = _encode(params, config, tokens, mesh)
    return _durations_from_hidden(params, config, tokens, hidden)


def regulate(hidden, durations, max_frames: int):
    """Static-shape length regulation: token i owns frames
    [ends_i - d_i, ends_i), ends = cumsum(d); frame t gathers its owner
    through a [T, S] boundary comparison.  Returns (frames [B, T, D],
    total frames [B])."""
    ends = torch.cumsum(durations, dim=1)                  # [B, S]
    starts = ends - durations
    t = torch.arange(max_frames, device=durations.device,
                     dtype=durations.dtype)[None, :, None]
    owner = ((t >= starts[:, None, :]) &
             (t < ends[:, None, :])).to(hidden.dtype)       # [B, T, S]
    return torch.matmul(owner, hidden), ends[:, -1]


def tts_forward(params, config: TTSConfig, tokens, durations=None,
                mesh=None):
    """tokens: [B, S] int (pad with 0) → (log-mel [B, max_frames,
    n_mels], total frames [B]).  durations=None predicts them.  mesh:
    this rank's shards (tts_axes); every rank returns the same mel."""
    hidden = _encode(params, config, tokens, mesh)
    if durations is None:
        _, durations = _durations_from_hidden(params, config, tokens,
                                              hidden)
    frames, total = regulate(hidden, durations.float(), config.max_frames)
    return L.linear(params["mel_head"], frames), total


@torch.no_grad()
def synthesize(params, config: TTSConfig, tokens, n_iter: int = 32,
               vocoder=None, vocoder_config=None, mesh=None):
    """tokens → (waveform [B, samples], voiced sample counts [B] int32):
    predicted durations → mel → waveform, all on the tokens' device.
    Callers trim each row to its count.  The mel → waveform leg is the
    neural vocoder when `vocoder` params are given, else Griffin-Lim
    (`n_iter` rounds).  mesh: the acoustic model's shards (tts_axes);
    the mel → waveform leg runs whole on every rank."""
    from ..ops.audio import WHISPER_HOP, griffin_lim, mel_to_linear

    mel, total_frames = tts_forward(params, config, tokens, mesh=mesh)
    if vocoder is not None:
        from .vocoder import vocoder_forward
        audio = vocoder_forward(vocoder, vocoder_config, mel.float())
    else:
        magnitude = mel_to_linear(mel.float(), num_mels=config.n_mels)
        audio = griffin_lim(magnitude, n_iter=n_iter)
    samples = torch.clamp(torch.ceil(total_frames), 0,
                          config.max_frames).to(torch.int32) * WHISPER_HOP
    return audio, samples
