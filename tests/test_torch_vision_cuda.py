"""The vision path's card-only branches: the pipelined results path's
pinned host copies and CUDA event (compute._to_host), the dct8 decode on
card tensors, and the detector and ResNet on the card against the same
modules on the CPU (f32, cuDNN's TF32 off inside the forward).  Every
test here needs an NVIDIA card and skips without one.  On the card, from
the repo root:
    python -m pytest --noconftest -m cuda tests/test_torch_vision_cuda.py -q
(nothing here imports jax)."""

import copy

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch import compute as C
from aiko_services_tpu_torch.models import detector as D
from aiko_services_tpu_torch.models import resnet as R
from aiko_services_tpu_torch.ops import image_wire as W

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (tensors on the card)")
    return torch.device("cuda")


def test_results_cross_to_pinned_host_copies_behind_one_event(card):
    results = (torch.arange(6, device=card).reshape(2, 3),
               torch.ones(4, device=card) * 2.5, 7,
               [torch.zeros(2, dtype=torch.int32, device=card)])
    host, event = C._to_host(results, card)
    assert isinstance(event, torch.cuda.Event)
    event.synchronize()
    assert host[0].device.type == "cpu" and host[0].is_pinned()
    assert host[1].is_pinned() and host[2] == 7
    assert host[0].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert host[1].tolist() == [2.5] * 4
    assert host[3][0].dtype == torch.int32 and host[3][0].is_pinned()


def test_dct8_decode_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(0)
    codes = np.stack([W.dct8_encode(rng.integers(
        0, 256, (64, 48, 3), dtype=np.uint8)) for _ in range(3)])
    cpu = W.dct8_decode(torch.from_numpy(codes), 64, 48)
    got = W.dct8_decode(torch.from_numpy(codes).to(card), 64, 48)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [64, 72])
def test_detector_on_the_card_matches_the_cpu(card, size):
    config = D.DETECTOR_PRESETS["detector_test"]
    model = D.detector_init(torch.Generator().manual_seed(0), config,
                            device="cpu")
    on_card = copy.deepcopy(model).to(card)
    x = torch.rand(3, size, size, 3, generator=torch.Generator()
                   .manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        want = D.detect(model, config, x, score_threshold=0.0)
        got = D.detect(on_card, config, x.to(card), score_threshold=0.0)
    assert torch.backends.cudnn.allow_tf32 == tf32     # scoped
    assert torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-3)


def test_resnet_logits_on_the_card_match_the_cpu(card):
    config = R.ResNetConfig(stage_sizes=(2, 2, 2, 2), num_classes=10,
                            width=16)
    model = R.resnet_init(torch.Generator().manual_seed(0), config,
                          device="cpu")
    on_card = copy.deepcopy(model).to(card)
    x = torch.rand(4, 57, 57, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = R.resnet_forward(model, config, x)
        got = R.resnet_forward(on_card, config, x.to(card))
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
