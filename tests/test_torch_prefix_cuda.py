"""The conversational agent's paged kernel paths on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_prefix_cuda.py -q

(--noconftest: tests/conftest.py imports jax; nothing here does.)
- A prefix-cached paged decoder on the card serves a small f32 model
  (64-wide heads, the kernel's) through full, partial and missed hits,
  two slots aliasing one chain and the seq-cap slide-back that copies a
  shared block, and gives the tokens the same decoder gives on the CPU
  (the kernel's plain version).  TF32 is off, so both sides round f32
  products alike; the kernel sums in another order, which moves logits
  by ~1e-6, far inside the model's top-2 gaps at these seeds.
- The chunk extend at the agent's shape (G = 4 x a 128-token chunk =
  512 query rows per KV head: two 256-row tiles of the tensor-core
  path, a 128-entry side buffer under the causal mask at W = 128, an
  offset inside a prefix two slots alias) against its plain version,
  under the tensor-core tolerance of tests/test_torch_kernels_cuda.py
  (c = 2^-8, relative L2 0.003)."""

import copy

import pytest
import torch

pytestmark = pytest.mark.cuda

PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
LONG = [(i * 7) % 50 + 1 for i in range(95)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _conversation(model, config, device):
    """Tokens of a fixed request script through a prefix-cached paged
    decoder on `device`, and its counters."""
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    cache = PrefixKVCache(block_tokens=8, max_bytes=64 << 20,
                          name=f"card_{device}")
    decoder = ContinuousDecoder(model, config, max_slots=4,
                                prefill_buckets=(64,), steps_per_sync=4,
                                prefill_chunk=16, paged_kv=True,
                                prefix_cache=cache, device=device)
    done = {}
    script = [{"donor": (PROMPT, 10)},
              {"full": (PROMPT, 10), "part": (PROMPT[:24] + [7, 9, 3], 8),
               "miss": ([9, 4, 2], 6)},
              {"s1": (PROMPT, 6), "s2": (PROMPT, 6)},
              {"w1": (LONG, 2)}, {"w2": (LONG, 2)}, {"w3": (LONG, 2)}]
    for wave in script:
        for request_id, (prompt, max_new) in wave.items():
            decoder.submit(request_id, prompt, max_new,
                           lambda rid, t: done.update({rid: list(t)}))
        while not decoder.idle:
            decoder.pump()
    assert decoder.pool.used_blocks() == len(cache)
    return done, {key: decoder.stats[key] for key in
                  ("prefix_admits", "tokens_prefill", "cow_copies")}


def test_prefix_cached_decoder_matches_the_cpu(card):
    from aiko_services_tpu_torch.models.llama import LlamaConfig, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    config = LlamaConfig(vocab=256, dim=256, ffn_dim=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=96)
    model = llama_init(torch.Generator().manual_seed(0), config,
                       device="cpu")
    expected, cpu_stats = _conversation(model, config, "cpu")
    before = P.launches["paged_decode_attention"]
    got, card_stats = _conversation(copy.deepcopy(model).to(card), config,
                                    None)
    assert P.launches["paged_decode_attention"] > before
    assert got == expected
    assert card_stats == cpu_stats
    assert card_stats["cow_copies"] >= 1 and \
        card_stats["prefix_admits"] >= 6


def test_agent_extend_shape_matches_plain(card):
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.ops.paged_attention import \
        paged_decode_attention_reference as plain
    generator = torch.Generator(device=card).manual_seed(5)
    slots, num_kv, chunk, block, nb = 3, 8, 128, 32, 40
    num_blocks = slots * nb + 1

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=card
                           ).to(torch.bfloat16)

    k_pool, v_pool = randn(num_blocks, num_kv, block, 64), \
        randn(num_blocks, num_kv, block, 64)
    k_pool[0] = v_pool[0] = 0
    offsets = torch.tensor([1000, 96, 0], dtype=torch.int32, device=card)
    ids = (torch.randperm(num_blocks - 1, generator=generator, device=card)
           + 1).to(torch.int32).view(slots, nb)
    ids[1, :4] = ids[0, :4]              # slot 1 aliases slot 0's prefix
    needed = (offsets.long() + chunk + block - 1) // block
    tables = ids.masked_fill(
        torch.arange(nb, device=card)[None] >= needed[:, None], 0)
    side_valid = torch.ones((chunk, chunk), dtype=torch.bool,
                            device=card).tril().expand(slots, chunk,
                                                       chunk).contiguous()
    q = randn(slots, num_kv, 4 * chunk, 64)
    k_side, v_side = randn(slots, num_kv, chunk, 64), \
        randn(slots, num_kv, chunk, 64)
    assert P.kernel_plan(True, slots, num_kv, 4 * chunk, nb * block,
                         132)[0] == P.TENSOR_PATH
    out = P.paged_decode_attention(q, k_pool, v_pool, tables, k_side,
                                   v_side, side_valid, offsets, groups=4,
                                   fold_scales=False)
    f32 = [x.float() for x in (q, k_pool, v_pool, k_side, v_side)]
    ref = plain(f32[0], f32[1], f32[2], tables, f32[3], f32[4], side_valid,
                offsets, groups=4, scale=0.125)
    magnitude = plain(f32[0], f32[1], f32[2].abs(), tables, f32[3],
                      f32[4].abs(), side_valid, offsets, groups=4,
                      scale=0.125)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    err = (out - ref).abs()
    assert (err - 2 ** -8 * magnitude).max().item() <= 0, err.max().item()
    assert (err.norm() / ref.norm()).item() <= 0.003
