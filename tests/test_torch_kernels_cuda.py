"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(--noconftest: tests/conftest.py imports jax, which the port's machine
need not have; nothing here imports jax.)  Shapes cover the edges the
main path does not reach: one head, ragged batch x heads, causal tiles,
strided layouts, T = 1, T not a multiple of 8, and a T whose scores
need more than 48 KB of shared memory."""

import pytest
import torch

from aiko_services_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

# The kernel's bf16 output against its plain version in f32 on the same
# input values, elementwise (x = sum_j p_j v_j / l):
#   |kernel - plain| <= U * |plain| + c * sum_j p_j |v_j| / l
# with U = 2^-8 (bf16 unit roundoff: the output's rounding) and c the
# kernel's own rounding (flash: bf16 probabilities, c = U; cross-decode:
# f32 throughout, c = 2^-12); and the relative L2 error of the whole
# output under a limit about 2.5x what rounding alone gives.  The same
# model as chip_smoke.py's.
U = 2 ** -8
FLASH = (U, 0.008)
CROSS = (2 ** -12, 0.004)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(generator, *shape):
    return torch.randn(*shape, generator=generator, device="cuda",
                       dtype=torch.float32).to(torch.bfloat16)


def _assert_close(out, plain, q, k, v, tolerance):
    """plain(q, k, v) is the kernel's plain version."""
    c, rel_l2_limit = tolerance
    q, k, v = q.float(), k.float(), v.float()
    ref, magnitude = plain(q, k, v), plain(q, k, v.abs())
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - ref).abs()
    excess = err - (U * ref.abs() + c * magnitude)
    assert excess.max().item() <= 0, err.max().item()
    assert (err.norm() / ref.norm()).item() <= rel_l2_limit


@pytest.mark.parametrize("layout", ["contiguous", "heads_last"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s", [(1, 1, 64), (2, 3, 128), (3, 5, 640)])
def test_flash_kernel_matches_plain(card, b, h, s, causal, layout):
    generator = torch.Generator(device=card).manual_seed(b * 100 + s)
    if layout == "contiguous":
        q, k, v = (_randn(generator, b, h, s, 64) for _ in range(3))
    else:   # [B, S, H, D] buffers viewed as heads, as layers.mha passes
        q, k, v = (_randn(generator, b, s, h, 64).permute(0, 2, 1, 3)
                   for _ in range(3))
    before = A.launches["flash_attention"]
    out = A.flash_attention(q, k, v, causal=causal)
    assert A.launches["flash_attention"] == before + 1
    assert out.shape == (b, h, s, 64) and out.dtype == torch.bfloat16
    _assert_close(out, lambda *x: A.flash_attention_reference(
        *x, causal=causal), q, k, v, FLASH)


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 128, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        A.flash_attention(q.float(), q.float(), q.float())
    narrow = torch.zeros((1, 2, 128, 32), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(narrow, narrow, narrow)
    ragged = torch.zeros((1, 2, 96, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64-row tile"):
        A.flash_attention(ragged, ragged, ragged)
    strided = torch.zeros((1, 2, 128, 128), device=card,
                          dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        A.flash_attention(strided, q, q)


@pytest.mark.parametrize("t", [1, 7, 200, 1536, 20000])
def test_cross_decode_kernel_matches_plain(card, t):
    generator = torch.Generator(device=card).manual_seed(t)
    b, h = 3, 5
    q = _randn(generator, b, 1, h * 64).view(b, 1, h, 64).permute(0, 2, 1, 3)
    k, v = (_randn(generator, b, t, h * 64).view(b, t, h, 64)
            .permute(0, 2, 1, 3) for _ in range(2))
    before = A.launches["cross_decode_attention"]
    out = A.cross_decode_attention(q, k, v)
    assert A.launches["cross_decode_attention"] == before + 1
    assert out.shape == (b, h, 1, 64)
    _assert_close(out, A.cross_decode_attention_reference, q, k, v, CROSS)
