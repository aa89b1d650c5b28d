"""The TTS leg and the MoE FFN on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_tts_cuda.py -q

(--noconftest: tests/conftest.py imports jax; nothing here does.)
- istft's overlap-add (F.fold: no atomics) gives the same bits on two
  runs, and Griffin-Lim on the card stays within 2e-3 of the CPU's
  STFT magnitudes (relative L2; the CPU port against JAX measured up to
  3.7e-4 after 32 rounds).
- The TTS model and the vocoder in f32 (TF32 off) on the card against
  the CPU: mel and waveform within 1e-4 relative L2; the totals within
  1e-4 + 1e-6 x the total (f32 sums of the durations in another order).
- moe_forward in bf16 and f32 on the card against the CPU on the same
  rows, drops included: the same drop count; f32 within 1e-5 of the
  largest output, bf16 within 2^-7 (a bf16 rounding on each side)."""

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import moe as TM
from aiko_services_tpu_torch.models import tts as TT
from aiko_services_tpu_torch.models import vocoder as TV
from aiko_services_tpu_torch.ops import audio as TA

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's device path)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32[0]
    torch.backends.cudnn.allow_tf32 = tf32[1]


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def magnitudes(batch=4, frames=256, seed=0):
    return torch.from_numpy(np.abs(np.random.default_rng(seed)
                                   .standard_normal((batch, frames, 201)))
                            .astype(np.float32))


def test_istft_is_deterministic_on_the_card(card):
    spectrum = TA.stft_complex(torch.randn(4, 160 * 511,
                                           generator=torch.Generator()
                                           .manual_seed(1)).to(card))
    first = TA.istft(spectrum)
    assert torch.equal(first, TA.istft(spectrum))
    cpu = TA.istft(spectrum.cpu())
    assert rel_l2(first.cpu(), cpu) <= 1e-5


def test_griffin_lim_card_against_cpu(card):
    mag = magnitudes()
    got = TA.griffin_lim(mag.to(card), n_iter=32).cpu()
    want = TA.griffin_lim(mag, n_iter=32)
    spec = lambda wave: TA.stft_complex(wave).abs().numpy()   # noqa: E731
    assert rel_l2(spec(got), spec(want)) <= 2e-3


def test_tts_and_vocoder_card_against_cpu(card):
    config = TT.TTS_PRESETS["base"]
    model = TT.tts_init(torch.Generator().manual_seed(0), config,
                        device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, 256, (4, config.max_tokens)).astype(np.int32))
    tokens[1, 40:] = 0
    mel_cpu, total_cpu = TT.tts_forward(model, config, tokens)
    mel, total = TT.tts_forward(model.to(card), config, tokens.to(card))
    assert rel_l2(mel.cpu(), mel_cpu) <= 1e-4
    assert torch.all((total.cpu() - total_cpu).abs() <=
                     1e-4 + 1e-6 * total_cpu.abs())
    vconfig = TV.VOCODER_PRESETS["base"]
    vocoder = TV.vocoder_init(torch.Generator().manual_seed(1), vconfig,
                              device="cpu")
    want = TV.vocoder_forward(vocoder, vconfig, mel_cpu[:, :128])
    got = TV.vocoder_forward(vocoder.to(card), vconfig,
                             mel_cpu[:, :128].to(card)).cpu()
    assert rel_l2(got, want) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_moe_forward_card_against_cpu(card, dtype, tol):
    config = TM.MoeConfig(dim=256, ffn_dim=512, num_experts=8, top_k=2,
                          dtype=dtype)
    model = TM.MoE(config, device="cpu")
    generator = torch.Generator().manual_seed(3)
    model.router.init_(generator)
    model.init_(generator)
    x = torch.randn(2, 40, 256, generator=generator).to(dtype)
    x[0, :30] = 0                            # equal logits: drops
    TM.drop_counts = []
    try:
        want, aux_want = TM.moe_forward(model, config, x)
        got, aux = TM.moe_forward(model.to(card), config, x.to(card))
        drops = [int(count) for count in TM.drop_counts]
    finally:
        TM.drop_counts = None
    assert drops[0] == drops[1] > 0
    got, want = got.float().cpu(), want.float()
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert abs(float(aux) - float(aux_want)) <= 1e-5
