"""The dense slot cache and speculative decoding on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_cuda.py -q

(--noconftest: tests/conftest.py imports jax; nothing here does.)
- The dense decoder (native and int8 with chunked prefill), the dense
  decoder with speculate_k 2 and the paged decoder with speculate_k 2
  and 4 serve a small f32 model (64-wide heads, the paged kernel's) on
  the card and give the tokens and counters the same decoders give on
  the CPU (plain PyTorch and the kernel's plain version).  TF32 is off,
  so both sides round f32 products alike; the card sums in other
  orders, which moves logits by ~1e-6, far inside the model's top-2
  gaps at these seeds.  The paged runs launch the kernel; the dense
  ones launch none.
- The speculative verify's shapes at the kernel: W = 3 (12 query rows a
  KV head: the split path) and W = 5 (20: the tensor-core path) in
  bf16, under the causal pos_side <= q_pos mask, against the plain
  version with the tolerances of tests/test_torch_kernels_cuda.py."""

import copy

import pytest
import torch

pytestmark = pytest.mark.cuda

PROMPT = [(i * 13) % 50 + 1 for i in range(40)]
LOOP = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _model():
    from aiko_services_tpu_torch.models.llama import LlamaConfig, llama_init
    config = LlamaConfig(vocab=256, dim=256, ffn_dim=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, max_seq_len=128)
    return config, llama_init(torch.Generator().manual_seed(0), config,
                              device="cpu")


def _serve(model, config, device, **kwargs):
    """Tokens and counters of a fixed traffic: three requests, two more
    after the second round, a 70-token prompt past the bucket."""
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    decoder = ContinuousDecoder(model, config, max_slots=4,
                                prefill_buckets=(64,), steps_per_sync=4,
                                device=device, **kwargs)
    done = {}

    def keep(rid, tokens):
        done[rid] = list(tokens)

    for rid, prompt, new in (("a", PROMPT, 12), ("loop", LOOP, 16),
                             ("long", (PROMPT * 2)[:70], 8)):
        decoder.submit(rid, prompt, new, keep)
    rounds = 0
    while not decoder.idle or rounds < 2:
        decoder.pump()
        rounds += 1
        if rounds == 2:
            decoder.submit("mid", PROMPT[:9] + [7], 10, keep)
            decoder.submit("tiny", [40, 2], 10, keep)
    if decoder.paged:
        assert decoder.pool.used_blocks() == 0
    return done, {key: decoder.stats[key] for key in
                  ("steps", "useful_steps", "tokens_decode",
                   "spec_proposed", "spec_accepted", "prefill_chunks")}


@pytest.mark.parametrize("kwargs", [
    {}, {"kv_cache_dtype": "int8", "prefill_chunk": 16},
    {"speculate_k": 2}, {"speculate_k": 2, "paged_kv": True},
    {"speculate_k": 4, "paged_kv": True, "kv_cache_dtype": "int8",
     "prefill_chunk": 16}],
    ids=["dense", "dense_int8_chunked", "dense_spec2", "paged_spec2",
         "paged_spec4_int8_chunked"])
def test_the_decoder_on_the_card_matches_the_cpu(card, kwargs):
    from aiko_services_tpu_torch.ops import paged_attention as P
    config, model = _model()
    expected, cpu_stats = _serve(model, config, "cpu", **kwargs)
    before = sum(P.launches.values())
    got, card_stats = _serve(copy.deepcopy(model).to(card), config, None,
                             **kwargs)
    launched = sum(P.launches.values()) - before
    assert got == expected
    assert card_stats == cpu_stats
    assert (launched > 0) == bool(kwargs.get("paged_kv"))
    if kwargs.get("speculate_k"):
        assert card_stats["spec_accepted"] > 0


@pytest.mark.parametrize("width,path", [(3, 0), (5, 1)])
def test_the_verify_shapes_match_plain(card, width, path):
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.ops.paged_attention import \
        paged_decode_attention_reference as plain
    generator = torch.Generator(device=card).manual_seed(width)
    slots, num_kv, groups, block, nb, steps = 4, 8, 4, 32, 8, 16
    num_blocks = slots * nb + 1
    side_len = steps * width

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=card
                           ).to(torch.bfloat16)

    k_pool, v_pool = randn(num_blocks, num_kv, block, 64), \
        randn(num_blocks, num_kv, block, 64)
    k_pool[0] = v_pool[0] = 0
    entries = torch.tensor([1, 77, 200, 256], dtype=torch.int32,
                           device=card)
    ids = (torch.randperm(num_blocks - 1, generator=generator, device=card)
           + 1).to(torch.int32).view(slots, nb)
    needed = (entries.long() + block - 1) // block
    tables = ids.masked_fill(
        torch.arange(nb, device=card)[None] >= needed[:, None], 0)
    # five verify blocks consumed so far (absolute positions from each
    # slot's entry length, two drafts rejected in each), the sixth live
    pos_side = torch.full((slots, side_len), 1 << 30, dtype=torch.int32,
                          device=card)
    lengths = entries.clone()
    for step in range(6):
        q_pos = lengths[:, None] + torch.arange(width, device=card)[None]
        kept = width if step == 5 else width - 2
        pos_side[:, step * width:step * width + kept] = q_pos[:, :kept]
        if step < 5:
            lengths = lengths + kept
    q_pos = lengths[:, None] + torch.arange(width, device=card)[None]
    side_valid = pos_side[:, None, :] <= q_pos[:, :, None]
    q = randn(slots, num_kv, groups * width, 64)
    k_side, v_side = randn(slots, num_kv, side_len, 64), \
        randn(slots, num_kv, side_len, 64)
    assert P.kernel_plan(True, slots, num_kv, groups * width, nb * block,
                         132)[0] == path
    out = P.paged_decode_attention(q, k_pool, v_pool, tables, k_side,
                                   v_side, side_valid, entries,
                                   groups=groups)
    f32 = [x.float() for x in (q, k_pool, v_pool, k_side, v_side)]
    ref = plain(f32[0], f32[1], f32[2], tables, f32[3], f32[4], side_valid,
                entries, groups=groups, scale=0.125)
    magnitude = plain(f32[0], f32[1], f32[2].abs(), tables, f32[3],
                      f32[4].abs(), side_valid, entries, groups=groups,
                      scale=0.125)
    torch.cuda.synchronize()
    c, limit = (2 ** -12, 1e-4) if path == P.SPLIT_PATH else \
        (2 ** -8, 0.003)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    err = (out - ref).abs()
    assert (err - c * magnitude).max().item() <= 0, err.max().item()
    assert (err.norm() / ref.norm()).item() <= limit
