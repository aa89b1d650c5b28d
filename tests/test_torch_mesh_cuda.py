"""The paged decoder's kernel build at construction, and the round note of
a decoder on a one-rank mesh, on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py -q

- A paged decoder built on the card has its kernel library loaded when
  its constructor returns, and serves with every nvcc start refused: no
  serving round builds a kernel (they look the library up).
- A decoder on create_mesh({"model": 1}) (an NCCL group of one) agrees
  its timed decisions in its round note, the gather skipped: a request
  whose deadline has passed is refused through on_refused at the round
  that agrees it, one whose deadline is far is served, and a drain with
  a zero deadline checkpoints the live slot and evacuates the queue at
  the next round, then resume serves again."""

import dataclasses
import subprocess

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _config():
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    # head dim 64: a width the paged kernel takes
    return dataclasses.replace(LLAMA_PRESETS["tiny"], dim=128, num_heads=2,
                               num_kv_heads=1, dtype=torch.bfloat16)


def _decoder(card, **kwargs):
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    config = _config()
    params = llama_init(torch.Generator(device=card).manual_seed(0), config,
                        device=card)
    return ContinuousDecoder(params, config, max_slots=2,
                             prefill_buckets=(16,), paged_kv=True,
                             kv_block=8, registry=MetricsRegistry(),
                             **kwargs), config


def test_no_serving_round_builds_a_kernel(card, monkeypatch):
    from aiko_services_tpu_torch.ops import kernels
    from aiko_services_tpu_torch.ops import paged_attention as P

    decoder, config = _decoder(card, device=card)
    source = P.paged_kernel_source(config.dtype, config.head_dim)
    kernels.load(source)                 # a lookup: raises if not loaded

    def refuse(*args, **kwargs):
        raise AssertionError("a serving round started a process")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    before = P.launches["paged_decode_attention"]
    done = {}
    decoder.submit("a", [1, 2, 3, 4], 6,
                   lambda rid, tokens: done.update({rid: list(tokens)}))
    for _ in range(50):
        if done:
            break
        decoder.pump()
    assert len(done["a"]) == 6
    assert P.launches["paged_decode_attention"] > before


def test_one_rank_mesh_sheds_and_drains_at_the_note(card):
    import time

    from aiko_services_tpu_torch.parallel import create_mesh
    from aiko_services_tpu_torch.parallel.sharding import local_shards
    from aiko_services_tpu_torch.models.llama import llama_axes

    mesh = create_mesh({"model": 1})
    whole, config = _decoder(card, device=card)
    params, _ = local_shards(whole.params, llama_axes(config), mesh,
                             config=config)
    from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    decoder = ContinuousDecoder(params, config, mesh=mesh, max_slots=2,
                                prefill_buckets=(16,), paged_kv=True,
                                kv_block=8, registry=MetricsRegistry())
    assert decoder.agreed and not decoder.sharded
    done, refused, evacuated = {}, {}, []

    def keep(rid, tokens):
        done[rid] = list(tokens)

    def refuse(rid, why):
        refused[rid] = why

    decoder.submit("warm", [1, 2, 3], 4, keep, on_refused=refuse)
    for _ in range(20):
        if "warm" in done:
            break
        decoder.pump()
    now = time.monotonic()
    assert decoder.submit("late", [5, 6], 40, keep, deadline=now - 1.0,
                          on_refused=refuse)
    decoder.submit("long", [5, 6], 40, keep, deadline=now + 1e9,
                   on_refused=refuse)
    decoder.submit("queued0", [7, 8], 40, keep, on_refused=refuse)
    decoder.submit("queued1", [9], 40, keep, on_refused=refuse)
    decoder.pump()
    assert refused == {"late": "shed"}
    listed = decoder.drain(deadline=0.0, on_evacuate=evacuated.append)
    assert listed == []                  # filled at the agreeing note
    for _ in range(10):
        if decoder.drained:
            break
        decoder.pump()
    assert decoder.drained
    assert sorted(e["request_id"] for e in evacuated) == ["long",
                                                          "queued0"]
    assert [e["request_id"] for e in listed] == ["queued1"]
    assert decoder.stats["drain_checkpoints"] == 2
    decoder.resume()
    decoder.submit("after", [3, 3], 4, keep, on_refused=refuse)
    for _ in range(20):
        if "after" in done:
            break
        decoder.pump()
    assert len(done["after"]) == 4
