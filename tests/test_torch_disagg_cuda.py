"""Disaggregated serving's KV ship and install on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_disagg_cuda.py -q

- A ship (serving_disagg._chain_wire_blocks: one gather per layer and
  plane into pinned memory, a CUDA event) and an install
  (PrefixKVCache.install_chain and ContinuousDecoder.
  install_shipped_blocks: one pinned staging buffer, non-blocking
  copies) round trip through the wire is bit-exact, for bf16 pools and
  for int8 pools with their scales, and the donor's blocks rewritten
  right after the ship do not reach the wire.
- torch's sync debug mode, set to raise, sees no synchronizing call on
  the ship or the install path.
- The disaggregated harness on the card serves a probe with the tokens
  of the colocated harness (f32, TF32 off) through the paged kernel."""

import dataclasses

import pytest
import torch

from aiko_services_tpu_torch.models.llama import LlamaConfig

pytestmark = pytest.mark.cuda

PROMPT = [(i * 13) % 200 + 1 for i in range(40)]
# head dim 64, the paged kernel's
CONFIG = LlamaConfig(vocab=256, dim=256, ffn_dim=512, num_layers=2,
                     num_heads=4, num_kv_heads=2, max_seq_len=128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def served_cache(device, int8: bool, dtype=torch.bfloat16):
    """(config, params, cache, decoder): a paged prefix-cached decoder on
    the card that has served PROMPT once (its chain is cached)."""
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    config = dataclasses.replace(CONFIG, dtype=dtype)
    params = llama_init(torch.Generator(device=device).manual_seed(0),
                        config, device=device)
    cache = PrefixKVCache(block_tokens=8, name=f"ship{int8}")
    decoder = ContinuousDecoder(
        params, config, max_slots=2, prefill_buckets=(64,), paged_kv=True,
        kv_block=8, prefix_cache=cache, device=device,
        kv_cache_dtype="int8" if int8 else None)
    done = {}
    decoder.submit("d", PROMPT, 2, lambda r, t: done.update({r: t}))
    while "d" not in done:
        decoder.pump()
    return config, params, cache, decoder


def receiver(config, params, device, int8: bool, cached: bool):
    from aiko_services_tpu_torch.serving import (ContinuousDecoder,
                                                 PrefixKVCache)
    cache = PrefixKVCache(block_tokens=8, name=f"land{int8}{cached}") \
        if cached else None
    return ContinuousDecoder(
        params, config, max_slots=2, prefill_buckets=(64,), paged_kv=True,
        kv_block=8, prefix_cache=cache, device=device,
        kv_cache_dtype="int8" if int8 else None)


def planes(leaf):
    return [leaf["q"], leaf["s"]] if isinstance(leaf, dict) else [leaf]


def block_equal(pool, block_id, other_pool, other_id) -> bool:
    mine, theirs = pool.block_rows(block_id), other_pool.block_rows(other_id)
    return all(torch.equal(a, b)
               for side in (0, 1)
               for leaf_a, leaf_b in zip(mine[side], theirs[side])
               for a, b in zip(planes(leaf_a), planes(leaf_b)))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cached", [True, False])
def test_ship_and_install_round_trip_bit_exact_without_syncs(card, int8,
                                                             cached):
    from aiko_services_tpu_torch.serving_disagg import (_chain_wire_blocks,
                                                        _landing)
    from aiko_services_tpu_torch.transport import wire

    config, params, cache, donor = served_cache(card, int8)
    keys, hit = cache.match("", PROMPT)
    assert hit == 40
    ids = [node.pool_id for node in cache.nodes(keys)]
    before = [[plane.clone() for leaf in side for plane in planes(leaf)]
              for side in donor.pool.block_rows(ids[0])]
    decoder = receiver(config, params, card, int8, cached)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows = _chain_wire_blocks(cache, keys)
        # the donor's blocks are rewritten right after the ship queued:
        # the copy runs first on the stream, so the wire keeps the old
        # bytes
        for pool in (donor.pool.k_pools, donor.pool.v_pools):
            for leaf in pool:
                for plane in planes(leaf):
                    plane[ids[0]] = 0
        while not rows.ready():
            pass
        payload = wire.encode_kv_transfer("t", "", PROMPT, 0, 8,
                                          cache.wire_layout(), rows.blocks)
        out = wire.decode_kv_transfer(payload)
        if cached:
            landed = decoder.prefix_cache.install_chain(
                "", out["tokens"], 0, _landing(out["blocks"]))
            landed_ids = [node.pool_id for node in
                          decoder.prefix_cache.nodes(keys)]
        else:
            covered, landed_ids = decoder.install_shipped_blocks(
                out["tokens"], 0, _landing(out["blocks"]))
            landed = covered // 8
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert landed == 5 and len(landed_ids) == 5
    torch.cuda.synchronize()
    # block 0 against its bytes before the rewrite, the rest against the
    # donor's pool
    got = [[plane for leaf in side for plane in planes(leaf)]
           for side in decoder.pool.block_rows(landed_ids[0])]
    assert all(torch.equal(a, b) for side_a, side_b in zip(got, before)
               for a, b in zip(side_a, side_b))
    for mine, theirs in zip(landed_ids[1:], ids[1:]):
        assert block_equal(decoder.pool, mine, donor.pool, theirs)


def test_disaggregated_harness_tokens_equal_colocated(card):
    """The probe through the two-pool harness on the card, f32: the
    disaggregated tokens equal the colocated ones, the decode side
    prefills only the suffix, and the paged kernel ran on both sides."""
    from aiko_services_tpu_torch.models.llama import llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving_disagg import DisaggHarness

    config = CONFIG
    params = llama_init(torch.Generator(device=card).manual_seed(0), config,
                        device=card)
    tokens = {}
    for disagg in (False, True):
        harness = DisaggHarness(
            params, config, disagg=disagg, block_tokens=8, max_slots=4,
            prefill_slots=2, prefill_chunk=16, prefill_buckets=(64,),
            transfer_timeout=60.0,
            decoder_opts={"paged_kv": True, "kv_block": 8})
        try:
            assert harness.wait_discovered(30.0)
            before = sum(P.launches.values())
            done = {}
            harness.submit("r", PROMPT, 10,
                           lambda r, t: done.update({r: list(t)}))
            assert harness.run_until(lambda: "r" in done, timeout=120.0)
            assert sum(P.launches.values()) > before
            tokens[disagg] = done["r"]
            if disagg:
                assert harness.client.stats["installs"] == 1
                assert harness.client.stats["local_fallbacks"] == 0
                assert harness.decoder.stats["tokens_prefill"] == 8
        finally:
            harness.stop()
    assert tokens[True] == tokens[False]
