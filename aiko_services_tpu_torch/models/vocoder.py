# Tiny neural vocoder in PyTorch: log-mel frames → waveform through a
# learned upsampling conv stack and a gated oscillator bank.
#
# Counterpart of aiko_services_tpu/models/vocoder.py: nearest-neighbour
# upsampling (repeat_interleave on the time axis) and a plain conv1d with
# symmetric padding per stage, leaky ReLU of slope 0.1; at the sample
# rate a bank of sin/cos oscillators at trainable mel-spaced frequencies
# (the `freqs` leaf) is gated per sample, a post conv and tanh give the
# wave, and a per-frame exponential gain from the mel drives silence to
# zero.  The stage factors multiply to the analysis hop (160), so T mel
# frames give T * 160 samples.
#
# The oscillator angle keeps the reference program's order of
# operations in f32, ((2π · t) · f) · (1 / sample_rate): XLA compiles the
# reference's division by the constant rate as a product with its f32
# reciprocal.  At 1024 frames the bank is 163,840 samples long, where one
# ulp of an angle is ~0.016 rad, so a true division would move sin and
# cos by ~1%.  In f32 the convolutions run with cuDNN's TF32 off
# (resnet.exact_f32).  vocoder_forward is differentiable, as JAX's is
# (tests/torch_golden.py trains through it).

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device, torch_dtype
from . import layers as L
from .resnet import exact_f32

__all__ = ["VocoderConfig", "Vocoder", "VOCODER_PRESETS", "vocoder_init",
           "vocoder_axes",
           "vocoder_forward", "oscillator_bank"]


@dataclass(frozen=True)
class VocoderConfig:
    """The JAX VocoderConfig field for field."""
    n_mels: int = 80
    hop: int = 160                    # product of upsample factors
    channels: tuple = (128, 64, 32)   # per-stage output channels
    upsample: tuple = (4, 5, 8)       # per-stage time expansion
    kernel: int = 9                   # odd: conv1d symmetric padding
    basis: int = 48                   # oscillator pairs
    basis_fmin: float = 60.0
    basis_fmax: float = 4000.0
    sample_rate: int = 16000
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "channels", tuple(self.channels))
        object.__setattr__(self, "upsample", tuple(self.upsample))
        product = math.prod(self.upsample)
        if product != self.hop:
            raise ValueError(f"upsample factors {self.upsample} "
                             f"multiply to {product}, need hop={self.hop}")
        if len(self.channels) != len(self.upsample):
            raise ValueError("need one channel width per upsample stage")


VOCODER_PRESETS = {
    "test": VocoderConfig(channels=(96, 48, 24), basis=64),
    "base": VocoderConfig(),
}


def _mel_spaced_frequencies(num: int, fmin: float, fmax: float) -> list:
    """`num` frequencies (Hz) equally spaced on the mel scale, in
    Python floats (the reference's arithmetic)."""
    def to_mel(f):
        return 2595.0 * math.log10(1.0 + f / 700.0)

    def from_mel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    lo, hi = to_mel(fmin), to_mel(fmax)
    return [from_mel(lo + (hi - lo) * i / (num - 1)) for i in range(num)]


class Vocoder(L.Params):
    """The vocoder's parameters, uninitialised (vocoder_init fills them;
    bridge.py copies a JAX param tree in)."""

    def __init__(self, config: VocoderConfig, device=None):
        super().__init__()
        self.config = config
        k, dtype = config.kernel, config.dtype
        widths = (config.n_mels,) + config.channels
        self.pre = L.Conv1d(config.n_mels, widths[1], k, dtype, device)
        self.stages = nn.ModuleList(
            L.Conv1d(widths[i + 1],
                     widths[i + 2] if i + 2 < len(widths) else widths[i + 1],
                     k, dtype, device)
            for i in range(len(config.upsample) - 1))
        # per-sample oscillator gates, per-frame log-gain, output conv
        self.gate = L.Conv1d(config.channels[-1], 2 * config.basis, k,
                             dtype, device)
        self.gain = L.Conv1d(config.n_mels, 1, k, dtype, device)
        self.post = L.Conv1d(config.channels[-1] + 2 * config.basis, 1, k,
                             dtype, device)
        # trainable oscillator frequencies (Hz), f32 as in the reference
        self.freqs = nn.Parameter(torch.empty(
            (config.basis,), dtype=torch.float32, device=device),
            requires_grad=False)

    @torch.no_grad()
    def init_(self, generator) -> None:
        config = self.config
        self.freqs.copy_(torch.tensor(_mel_spaced_frequencies(
            config.basis, config.basis_fmin, config.basis_fmax),
            dtype=torch.float32))


@torch.no_grad()
def vocoder_init(generator: torch.Generator, config: VocoderConfig,
                 device=None) -> Vocoder:
    """A Vocoder with random conv weights drawn from `generator` and
    mel-spaced frequencies.  device=None means the CUDA card."""
    model = Vocoder(config, device=resolve_device(device))
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    return model


def vocoder_axes(config: VocoderConfig):
    return {
        "pre": L.conv1d_axes(),
        "stages": [L.conv1d_axes()] * (len(config.upsample) - 1),
        "gate": L.conv1d_axes(),
        "gain": L.conv1d_axes(),
        "post": L.conv1d_axes(),
        "freqs": None,
    }


def oscillator_bank(length: int, config: VocoderConfig, freqs):
    """[length, 2 * basis] sin/cos of ((2π · t) · f) · (1 / sample_rate)
    at the absolute sample index t, in f32, cast to the config's
    dtype."""
    t = torch.arange(length, device=freqs.device,
                     dtype=torch.float32)[:, None]
    angles = 2.0 * math.pi * t * freqs.float()[None, :] * \
        (1.0 / config.sample_rate)
    return torch.cat([torch.sin(angles), torch.cos(angles)],
                     dim=-1).to(config.dtype)


def vocoder_forward(params, config: VocoderConfig, mel):
    """log-mel [B, T, n_mels] → waveform [B, T * hop] in [-1, 1]."""
    with exact_f32(config.dtype):
        mel = mel.to(config.dtype)
        x = F.leaky_relu(L.conv1d(params["pre"], mel), 0.1)
        x = torch.repeat_interleave(x, config.upsample[0], dim=1)
        for i, stage in enumerate(params["stages"]):
            x = F.leaky_relu(L.conv1d(stage, x), 0.1)
            x = torch.repeat_interleave(x, config.upsample[i + 1], dim=1)
        source = oscillator_bank(x.shape[1], config, params["freqs"])
        # the gates are the learned filter, the bank the source
        modulated = L.conv1d(params["gate"], x) * source[None]
        x = torch.cat([x, modulated], dim=-1)
        wave = torch.tanh(L.conv1d(params["post"], x))[..., 0]
        log_gain = L.conv1d(params["gain"], mel)[..., 0]      # [B, T]
        gain = torch.exp(torch.repeat_interleave(log_gain, config.hop,
                                                 dim=1))
        return wave * gain
