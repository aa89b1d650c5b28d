"""The host KV tier and the W8A16 linears on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_tiered_cuda.py -q

- A demote -> promote round trip of pool blocks (bf16, and int8 with its
  scales) through pinned host memory is bit-exact, through the worker's
  own stream (prefetch, then poll) and inline (promote_for), with the
  freed device blocks rewritten in between; torch's sync debug mode
  records no synchronizing call in the tier's copies.
- weight_quant's logits (int8 weights, per-channel scales, f32
  accumulation) on the card equal the CPU's within 1e-5 in f32 (TF32
  off), and a weight-quantized decoder's greedy tokens equal the CPU's."""

import copy
import dataclasses
import time
import warnings

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def tiered_pool(device, int8: bool):
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    from aiko_services_tpu_torch.serving import PrefixKVCache
    from aiko_services_tpu_torch.serving_paged import BlockPool
    from aiko_services_tpu_torch.serving_tiered import HostBlockStore
    config = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=torch.bfloat16)
    pool = BlockPool(config, 8, int8, initial_blocks=16, device=device)
    cache = PrefixKVCache(block_tokens=8, max_bytes=1 << 20,
                          name=f"cuda_tier{int8}")
    cache.bind((config.num_layers, config.num_kv_heads, config.head_dim,
                str(config.dtype), int8, 8, 2), paged=True)
    cache.attach_pool(pool)
    store = HostBlockStore(name=f"cuda_tier{int8}h")
    cache.attach_host_store(store)
    return config, pool, cache, store


def random_rows(config, count: int, int8: bool, generator, device):
    shape = (count, config.num_kv_heads, 8, config.head_dim)
    if int8:
        return {"q": torch.randint(-127, 128, shape, generator=generator,
                                   device=device, dtype=torch.int8),
                "s": torch.rand(shape[:3], generator=generator,
                                device=device)}
    return torch.randn(shape, generator=generator, device=device).to(
        torch.bfloat16)


def snapshot(pool, block_id: int) -> list:
    k_rows, v_rows = pool.block_rows(block_id)
    return [{key: plane.clone() for key, plane in leaf.items()}
            if isinstance(leaf, dict) else leaf.clone()
            for leaf in k_rows + v_rows]


def same(a, b) -> bool:
    if isinstance(a, dict):
        return all(torch.equal(a[key], b[key]) for key in a)
    return torch.equal(a, b)


def fill_chain(config, pool, cache, int8, generator, device, tokens):
    """Four blocks of random rows inserted as the chain of `tokens`,
    pinned under a session; returns their rows by key."""
    ids = pool.alloc_blocks(4)
    layers = config.num_layers
    pool.write_blocks(ids, [random_rows(config, 4, int8, generator, device)
                            for _ in range(layers)],
                      [random_rows(config, 4, int8, generator, device)
                       for _ in range(layers)])
    keys = cache.keys_for("t", tokens[:32])
    parent = ""
    for key, block_id in zip(keys, ids):
        assert cache.insert_block("t", parent, key, block_id)
        parent = key
    pool.release_blocks(ids)                  # the cache holds the refs
    cache.session_store("t", "s", tokens)
    return {key: snapshot(pool, block_id) for key, block_id in zip(keys, ids)}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("route", ["prefetch", "promote_for"])
def test_demote_promote_round_trip_is_bit_exact(card, int8, route):
    config, pool, cache, store = tiered_pool(card, int8)
    generator = torch.Generator(device=card).manual_seed(3)
    tokens = list(range(1, 42))               # 41 tokens: 5 blocks probed
    rows = fill_chain(config, pool, cache, int8, generator, card, tokens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert cache.demote_sessions([("t", "s")]) == 4
            # the freed blocks are rewritten at once: the demotion's copies
            # are queued ahead of these writes on the stream
            fresh = pool.alloc_blocks(4)
            pool.write_blocks(fresh, [random_rows(config, 4, int8,
                                                  generator, card)
                                      for _ in range(config.num_layers)],
                              [random_rows(config, 4, int8, generator, card)
                               for _ in range(config.num_layers)])
            if route == "prefetch":
                assert cache.prefetch("t", tokens) == 32
                deadline = time.monotonic() + 10.0
                while not cache.promotions_ready and \
                        time.monotonic() < deadline:
                    time.sleep(0.002)
                assert cache.poll_promotions() == 32
            else:
                assert cache.promote_for("t", tokens) == 32
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    assert not syncs
    assert len(store) == 0 and cache.match("t", tokens)[1] == 32
    for key, want in rows.items():
        got = snapshot(pool, cache.nodes([key])[0].pool_id)
        assert all(same(a, b) for a, b in zip(got, want)), key
    stats = cache.promoter.stats
    assert stats["installs_async" if route == "prefetch"
                 else "installs_sync"] == 4
    pool.release_blocks(fresh)
    cache.purge(demote=False)
    assert pool.used_blocks() == 0
    cache.promoter.stop()


def test_weight_quant_logits_and_tokens_match_the_cpu(card):
    from aiko_services_tpu_torch.models import layers as L
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    # 64-wide heads: the paged kernel's
    config = dataclasses.replace(LLAMA_PRESETS["tiny"], dim=128,
                                 num_heads=2, num_kv_heads=1)
    cpu_model = llama_init(torch.Generator().manual_seed(5), config,
                           device="cpu")
    card_model = copy.deepcopy(cpu_model).to(card)
    cpu_tree = L.quantize_linear_tree(cpu_model)
    card_tree = L.quantize_linear_tree(card_model)
    assert torch.equal(card_tree["lm_head"]["w8"].cpu(),
                       cpu_tree["lm_head"]["w8"])
    x = torch.randn((6, config.dim), generator=torch.Generator().manual_seed(
        6))
    want = L.linear_logits(cpu_tree["lm_head"], x)
    got = L.linear_logits(card_tree["lm_head"], x.to(card)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    prompts = {f"r{i}": [(i * 7 + j * 3) % 200 + 1 for j in range(5 + i)]
               for i in range(3)}
    outs = []
    for model, device in ((cpu_model, "cpu"), (card_model, card)):
        decoder = ContinuousDecoder(model, config, device=device,
                                    max_slots=4, prefill_buckets=(16,),
                                    steps_per_sync=4, paged_kv=True,
                                    kv_block=8, weight_quant=True)
        done = {}
        for rid, prompt in prompts.items():
            decoder.submit(rid, prompt, 10,
                           lambda r, t: done.update({r: list(t)}))
        while not decoder.idle:
            decoder.pump()
        outs.append(done)
    assert outs[1] == outs[0]
