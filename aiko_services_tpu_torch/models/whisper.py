# Whisper: encoder-decoder speech recognition in PyTorch.
#
# Counterpart of aiko_services_tpu/models/whisper.py.  Architecture
# (Radford et al., "Robust Speech Recognition via Large-Scale Weak
# Supervision"): log-mel [B, T, 80] → 2×conv(gelu, stride 1/2) →
# sinusoidal positions → pre-norm transformer encoder; decoder = learned
# positions + causal self-attention + cross-attention, weight-tied
# logits.  The Whisper module's parameter names map 1:1 onto the JAX
# package's flat-npz keys (enc_blocks.3.attn.q.w ↔ enc_blocks/3/attn/q/w).
# Greedy decode is a Python loop over static-shape KV caches (the JAX
# package's lax.scan), with the same EOT fill and logprob accounting.
#
# Tensor parallelism (mesh=): the functions take the model's own config
# and this rank's shards of a model axis (parallel.local_shards with
# whisper_axes for serving; the train step's local views of its
# DTensors), as GSPMD partitions JAX's program over whisper_axes: q, k,
# v and mlp_in are column-parallel (the rank's heads and its share of
# the FFN's 4·dim), attn.o, cross.o and mlp_out row-parallel, each
# followed by a sum over the model axis (layers.row_parallel_linear);
# the tied embedding and head hold the rank's vocabulary chunk, ceil(
# n_vocab / n) rows with the last one padded (parallel/sharding.py), so
# decode_step's logits are the rank's chunk with the padding at -inf,
# and the greedy pick and its logprob reduce over the chunks
# (collectives.greedy_pick_scored, shifted_logsumexp).  Under autograd
# the sums and the column-parallel inputs use the collectives' autograd
# pair, so a loss backpropagates into the shards.  With mesh=None, or a
# model axis of one rank, nothing changes: the same launches and the
# same numbers.

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from . import layers as L

__all__ = ["WhisperConfig", "Whisper", "whisper_init", "whisper_axes",
           "local_heads", "encode",
           "precompute_cross_kv", "init_caches", "decode_step",
           "greedy_decode_scored", "greedy_decode_from_audio", "forward",
           "WHISPER_PRESETS", "sot_sequence_for", "parse_timestamp_segments",
           "LANGUAGES"]


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500        # frames after stride-2 conv (30 s)
    n_text_ctx: int = 448
    n_vocab: int = 51865
    dim: int = 768
    num_heads: int = 12
    enc_layers: int = 12
    dec_layers: int = 12
    dtype: torch.dtype = torch.float32
    # special tokens (multilingual tokenizer defaults); presets with small
    # vocabularies override them so the ids stay in range
    sot: int = 50258
    eot: int = 50257

    def __post_init__(self):
        # accept the JAX config's spellings (jnp.bfloat16, "float32", ...)
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def head_dim(self):
        return self.dim // self.num_heads


WHISPER_PRESETS = {
    # not a real whisper size: CI/smoke geometry (real 80-mel frontend,
    # toy transformer) so end-to-end tests run in seconds on the CPU
    "test":   WhisperConfig(dim=64,   num_heads=4,  enc_layers=2,
                            dec_layers=2, n_vocab=256, sot=254, eot=255),
    "tiny":   WhisperConfig(dim=384,  num_heads=6,  enc_layers=4,
                            dec_layers=4),
    "base":   WhisperConfig(dim=512,  num_heads=8,  enc_layers=6,
                            dec_layers=6),
    "small":  WhisperConfig(dim=768,  num_heads=12, enc_layers=12,
                            dec_layers=12),
    "medium": WhisperConfig(dim=1024, num_heads=16, enc_layers=24,
                            dec_layers=24),
    "large":  WhisperConfig(dim=1280, num_heads=20, enc_layers=32,
                            dec_layers=32),
}

# Special tokens (multilingual tokenizer ids, as in openai/whisper)
SOT = 50258
EOT = 50257
TOKEN_TRANSLATE = 50358
TOKEN_TRANSCRIBE = 50359
TOKEN_NO_TIMESTAMPS = 50363
TOKEN_TIMESTAMP_BEGIN = 50364       # <|0.00|>; each id adds 0.02 s
TIMESTAMP_STEP_S = 0.02

# Language order of the multilingual tokenizer: token id for language i
# is SOT + 1 + i
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl",
    "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk",
    "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr",
    "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn",
    "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne",
    "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn",
    "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi",
    "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my",
    "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su")


def sot_sequence_for(config: WhisperConfig, language: str | None = None,
                     task: str = "transcribe",
                     timestamps: bool = False) -> tuple:
    """The start-of-transcript prompt that conditions decoding, as in
    openai/whisper: <|sot|> [<|lang|> <|task|>] [<|notimestamps|>].
    Language/task tokens need the multilingual vocab; asking for them on
    a small-vocab preset is an error."""
    if task not in ("transcribe", "translate"):
        raise ValueError(f"unknown task {task!r}")
    if task == "translate" and language is None:
        raise ValueError("task='translate' requires a language")
    sequence = [config.sot]
    if language is not None:
        if language not in LANGUAGES:
            raise ValueError(f"unknown language {language!r}")
        lang_token = SOT + 1 + LANGUAGES.index(language)
        task_token = {"transcribe": TOKEN_TRANSCRIBE,
                      "translate": TOKEN_TRANSLATE}[task]
        if max(lang_token, task_token) >= config.n_vocab:
            raise ValueError(
                f"language/task conditioning needs the multilingual "
                f"vocab (n_vocab {config.n_vocab} too small)")
        sequence += [lang_token, task_token]
    if not timestamps and TOKEN_NO_TIMESTAMPS < config.n_vocab:
        sequence.append(TOKEN_NO_TIMESTAMPS)
    return tuple(sequence)


def parse_timestamp_segments(tokens, length: int,
                             timestamp_begin: int = TOKEN_TIMESTAMP_BEGIN):
    """Split a decoded token sequence on timestamp tokens.

    Returns (segments, text_tokens): segments are
    {"start": s, "end": s, "tokens": [...]} with seconds decoded from
    the 0.02 s grid; text_tokens is everything with the timestamp
    markers stripped."""
    segments, text_tokens = [], []
    current, start = [], None
    for token in list(tokens)[:length]:
        token = int(token)
        if token >= timestamp_begin:
            seconds = (token - timestamp_begin) * TIMESTAMP_STEP_S
            if start is None:
                start = seconds
            else:
                segments.append({"start": start, "end": seconds,
                                 "tokens": current})
                current, start = [], None
        else:
            current.append(token)
            text_tokens.append(token)
    if current:
        segments.append({"start": start or 0.0, "end": None,
                         "tokens": current})
    return segments, text_tokens


# -- the model ---------------------------------------------------------------

class Block(L.Params):
    def __init__(self, config: WhisperConfig, cross: bool, device=None):
        super().__init__()
        dim, heads, dtype = config.dim, config.num_heads, config.dtype
        self.ln_attn = L.LayerNorm(dim, dtype, device)
        self.attn = L.MHA(dim, heads, dtype=dtype, device=device)
        self.ln_mlp = L.LayerNorm(dim, dtype, device)
        self.mlp_in = L.Linear(dim, dim * 4, True, dtype, device)
        self.mlp_out = L.Linear(dim * 4, dim, True, dtype, device)
        if cross:
            self.ln_cross = L.LayerNorm(dim, dtype, device)
            self.cross = L.MHA(dim, heads, dtype=dtype, device=device)


class Whisper(L.Params):
    """Whisper's parameters, uninitialised (whisper_init fills them from a
    generator; bridge.py copies a JAX param tree in)."""

    def __init__(self, config: WhisperConfig, device=None):
        super().__init__()
        self.config = config
        dim, dtype = config.dim, config.dtype
        self.conv1 = L.Conv1d(config.n_mels, dim, 3, dtype, device)
        self.conv2 = L.Conv1d(dim, dim, 3, dtype, device)
        self.enc_blocks = nn.ModuleList(
            Block(config, False, device) for _ in range(config.enc_layers))
        self.ln_enc = L.LayerNorm(dim, dtype, device)
        self.tok_embed = L.Embedding(config.n_vocab, dim, dtype, device)
        self.pos_embed = nn.Parameter(
            torch.empty((config.n_text_ctx, dim), dtype=dtype,
                        device=device), requires_grad=False)
        self.dec_blocks = nn.ModuleList(
            Block(config, True, device) for _ in range(config.dec_layers))
        self.ln_dec = L.LayerNorm(dim, dtype, device)

    def forward(self, mel, tokens):
        return forward(self, self.config, mel, tokens)


@torch.no_grad()
def whisper_init(generator: torch.Generator, config: WhisperConfig,
                 device=None) -> Whisper:
    """A Whisper with random weights drawn from `generator` (the JAX
    package's distributions; its numbers differ, as torch and jax random
    streams do).  device=None means the CUDA card."""
    model = Whisper(config, device=resolve_device(device))
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    L._normal_(model.pos_embed, generator, 0.01)
    return model


def _block_axes(cross: bool):
    axes = {
        "ln_attn": L.layer_norm_axes(),
        "attn": L.mha_axes(),
        "ln_mlp": L.layer_norm_axes(),
        "mlp_in": L.linear_axes("embed", "ffn"),
        "mlp_out": L.linear_axes("ffn", "embed"),
    }
    if cross:
        axes["ln_cross"] = L.layer_norm_axes()
        axes["cross"] = L.mha_axes()
    return axes


def whisper_axes(config: WhisperConfig):
    """Each parameter's logical axes, shaped like the JAX param tree."""
    return {
        "conv1": L.conv1d_axes(),
        "conv2": L.conv1d_axes(),
        "enc_blocks": [_block_axes(False)] * config.enc_layers,
        "ln_enc": L.layer_norm_axes(),
        "tok_embed": L.embedding_axes(),
        "pos_embed": (None, "embed"),
        "dec_blocks": [_block_axes(True)] * config.dec_layers,
        "ln_dec": L.layer_norm_axes(),
    }


def local_heads(config: WhisperConfig, mesh=None) -> int:
    """This rank's attention heads: the config's over the size of the
    model axis (heads map to it under DEFAULT_RULES); all of them
    without a mesh.  Heads that do not divide raise ValueError, as
    JAX's placement does (only the vocabulary pads)."""
    return L.model_share(config.num_heads, "num_heads", mesh)


def _mlp(block, x, mesh=None):
    hidden = L.linear(block["mlp_in"], L.enter_columns(x, mesh))
    return L.row_parallel_linear(block["mlp_out"], L.gelu(hidden), mesh)


def _encoder_block(block, x, num_heads, mesh=None):
    attn_out, _ = L.mha(block["attn"], L.layer_norm(block["ln_attn"], x),
                        num_heads=num_heads, mesh=mesh)
    x = x + attn_out
    return x + _mlp(block, L.layer_norm(block["ln_mlp"], x), mesh)


def encode(params, config: WhisperConfig, mel, mesh=None):
    """mel: [B, T_frames, n_mels] → audio features [B, T_frames/2, dim]
    (the same on every rank of a mesh)."""
    x = L.gelu(L.conv1d(params["conv1"], mel.to(config.dtype)))
    x = L.gelu(L.conv1d(params["conv2"], x, stride=2))
    positions = L.sinusoid_position_encoding(x.shape[1], config.dim,
                                             device=x.device)
    x = x + positions.to(x.dtype)
    heads = local_heads(config, mesh)
    for block in params["enc_blocks"]:
        x = _encoder_block(block, x, heads, mesh)
    return L.layer_norm(params["ln_enc"], x)


def _decoder_block(block, x, cross_kv, num_heads, self_cache, mask,
                   mesh=None):
    attn_out, self_cache = L.cached_mha(
        block["attn"], L.layer_norm(block["ln_attn"], x), self_cache,
        mask=mask, num_heads=num_heads, mesh=mesh)
    x = x + attn_out
    cross_out, _ = L.mha(block["cross"],
                         L.layer_norm(block["ln_cross"], x),
                         precomputed_kv=cross_kv, num_heads=num_heads,
                         mesh=mesh)
    x = x + cross_out
    return x + _mlp(block, L.layer_norm(block["ln_mlp"], x), mesh), \
        self_cache


def precompute_cross_kv(params, config: WhisperConfig, audio,
                        quantize=False, mesh=None):
    """Project every decoder block's cross-attention K/V over the audio
    features once per utterance.  quantize: False, True/"position"
    (int8, per-position scales) or "tensor" (int8, one scale per batch
    element, folded into the attention by mha).  mesh: this rank's
    heads."""
    heads = local_heads(config, mesh)
    kv = [L.precompute_kv(block["cross"], audio, heads, mesh)
          for block in params["dec_blocks"]]
    if quantize:
        mode = quantize if isinstance(quantize, str) else "position"
        kv = [(L.quantize_kv(k, mode), L.quantize_kv(v, mode))
              for k, v in kv]
    return kv


def init_caches(config: WhisperConfig, batch: int,
                max_len: int | None = None, device=None, mesh=None):
    """The decoder's self-attention caches, of this rank's heads on a
    mesh."""
    max_len = max_len or config.n_text_ctx
    device = resolve_device(device)
    return [L.init_kv_cache(batch, max_len, local_heads(config, mesh),
                            config.head_dim, config.dtype, device)
            for _ in range(config.dec_layers)]


def decode_step(params, config: WhisperConfig, tokens, cross_kv, caches,
                position_offset: int = 0, mesh=None):
    """tokens: [B, T_step]; cross_kv is precompute_cross_kv(...)'s output
    (raw audio features are also accepted and projected here).  Returns
    (logits [B, T_step, vocab] f32, new_caches); the caches are updated
    in place.  mesh: the logits are this rank's vocabulary chunk, its
    padding columns (ids at or past n_vocab) at -inf."""
    if not isinstance(cross_kv, (list, tuple)):
        cross_kv = precompute_cross_kv(params, config, cross_kv,
                                       mesh=mesh)
    x = L.embedding(params["tok_embed"], tokens, mesh)
    t = tokens.shape[1]
    x = x + params["pos_embed"][position_offset:position_offset + t][None]
    x = x.to(config.dtype)

    mask = None
    if t > 1:       # prompt prefill needs a causal mask within the step
        device = tokens.device
        q_pos = position_offset + torch.arange(t, device=device)[:, None]
        k_pos = torch.arange(caches[0]["k"].shape[2], device=device)[None]
        mask = (k_pos <= q_pos)[None, None]

    new_caches = []
    heads = local_heads(config, mesh)
    for block, block_kv, cache in zip(params["dec_blocks"], cross_kv,
                                      caches):
        x, cache = _decoder_block(block, x, block_kv, heads, cache, mask,
                                  mesh)
        new_caches.append(cache)
    x = L.enter_columns(L.layer_norm(params["ln_dec"], x), mesh)
    logits = torch.matmul(x.float(),
                          params["tok_embed"]["table"].float().t())
    if L._model_axis_spans(mesh):
        from ..parallel.collectives import mask_vocab_padding
        logits = mask_vocab_padding(logits, "model", mesh=mesh,
                                    vocab=config.n_vocab)
    return logits, new_caches


def greedy_decode_scored(params, config: WhisperConfig, mel,
                         max_tokens: int = 64, sot_sequence=None,
                         suppress_timestamps: bool = False,
                         kv_quant=False, mesh=None):
    """Batched greedy decoding with per-sequence quality scores.

    mel: [B, T_frames, n_mels] →
    (tokens [B, max_tokens] int32, lengths [B] int32, avg_logprob [B]).
    Finished sequences keep emitting EOT; avg_logprob is the mean
    log-probability of the emitted tokens, EOT included.
    suppress_timestamps masks ids >= TOKEN_TIMESTAMP_BEGIN out of the
    argmax.  mesh: this rank's shards; every rank returns the same
    tokens, lengths and scores."""
    with torch.inference_mode():
        return greedy_decode_from_audio(
            params, config, encode(params, config, mel, mesh), max_tokens,
            sot_sequence, suppress_timestamps, kv_quant, mesh)


@torch.inference_mode()
def greedy_decode_from_audio(params, config: WhisperConfig, audio,
                             max_tokens: int = 64, sot_sequence=None,
                             suppress_timestamps: bool = False,
                             kv_quant=False, mesh=None):
    """greedy_decode_scored from already-encoded audio features
    [B, n_audio_ctx, dim]."""
    if sot_sequence is None:
        sot_sequence = (config.sot,)
    eot = config.eot
    if max(max(sot_sequence), eot) >= config.n_vocab:
        raise ValueError(
            f"special tokens {tuple(sot_sequence)}/eot={eot} out of range "
            f"for n_vocab={config.n_vocab}")
    total = len(sot_sequence) + max_tokens
    if total > config.n_text_ctx:
        raise ValueError(
            f"sot({len(sot_sequence)}) + max_tokens({max_tokens}) exceeds "
            f"n_text_ctx({config.n_text_ctx})")
    batch, device = audio.shape[0], audio.device
    cross_kv = precompute_cross_kv(params, config, audio,
                                   quantize=kv_quant, mesh=mesh)
    caches = init_caches(config, batch, max_len=total, device=device,
                         mesh=mesh)
    sharded = L._model_axis_spans(mesh)

    ts_mask = None
    if suppress_timestamps and TOKEN_TIMESTAMP_BEGIN < config.n_vocab:
        width = params["tok_embed"]["table"].shape[0]
        ids = torch.arange(width, device=device)
        if sharded:
            from ..parallel.collectives import vocab_offset
            ids = ids + vocab_offset(width, "model", mesh=mesh)
        ts_mask = ids >= TOKEN_TIMESTAMP_BEGIN

    def pick(logits_last):
        if ts_mask is not None:
            logits_last = logits_last.masked_fill(ts_mask, float("-inf"))
        if sharded:
            # the pick and log_softmax's value at it over the chunks:
            # the token is the global max, so its logprob is
            # (value - top) - log Σ exp(logits - top)
            from ..parallel.collectives import (greedy_pick_scored,
                                                shifted_logsumexp)
            token, value = greedy_pick_scored(logits_last, "model",
                                              mesh=mesh)
            top, log_total = shifted_logsumexp(logits_last, "model",
                                               mesh=mesh)
            return token, (value - top) - log_total
        token = torch.argmax(logits_last, dim=-1)
        logprob = torch.log_softmax(logits_last, dim=-1).gather(
            -1, token[:, None])[:, 0]
        return token.to(torch.int32), logprob

    # prefill the start-of-transcript prompt, filled on the device: a
    # host-to-device copy of the list would wait for the queued work
    prompt = torch.empty((batch, len(sot_sequence)), dtype=torch.int64,
                         device=device)
    for column, token_id in enumerate(sot_sequence):
        prompt[:, column] = token_id
    logits, caches = decode_step(params, config, prompt, cross_kv, caches,
                                 mesh=mesh)
    token, token_logprob = pick(logits[:, -1])

    done = torch.zeros(batch, dtype=torch.bool, device=device)
    logprob_sum = torch.zeros(batch, dtype=torch.float32, device=device)
    count = torch.zeros(batch, dtype=torch.int32, device=device)
    emitted = []
    for step in range(max_tokens):
        # the carry token is EMITTED this step: its logprob (computed
        # when it was chosen) is scored now, so the final never-emitted
        # carry token never biases the mean
        logprob_sum = logprob_sum + torch.where(
            done, torch.zeros_like(token_logprob), token_logprob)
        count = count + (~done).to(torch.int32)
        done = done | (token == eot)
        logits, caches = decode_step(
            params, config, token[:, None].long(), cross_kv, caches,
            position_offset=len(sot_sequence) + step, mesh=mesh)
        next_token, next_logprob = pick(logits[:, -1])
        emitted.append(token)
        token = torch.where(done, torch.full_like(next_token, eot),
                            next_token)
        token_logprob = next_logprob
    tokens = torch.stack(emitted, dim=1)             # [B, max_tokens]
    lengths = (tokens != eot).sum(dim=1).to(torch.int32)
    return tokens, lengths, logprob_sum / torch.clamp(count, min=1)


def forward(params, config: WhisperConfig, mel, tokens, mesh=None):
    """Teacher-forced forward: mel [B, T, n_mels], tokens [B, S] →
    logits [B, S, vocab] (mesh: this rank's vocabulary chunk, as
    decode_step's; train.cross_entropy_loss with the mesh takes it)."""
    audio = encode(params, config, mel, mesh)
    batch, s = tokens.shape
    caches = init_caches(config, batch, max_len=s, device=tokens.device,
                         mesh=mesh)
    logits, _ = decode_step(params, config, tokens, audio, caches,
                            mesh=mesh)
    return logits
