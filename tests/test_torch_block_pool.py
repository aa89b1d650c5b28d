"""The port's paged KV BlockPool (aiko_services_tpu_torch.serving_paged),
native and int8; the dense slot cache as ContinuousDecoder's default, the
speculative and dense options serving, and measure_device_step in each
mode; and the options of ContinuousDecoder that the port does not
implement yet: each raises NotImplementedError naming its ROADMAP.md
item, none is accepted and ignored."""

import pytest
import torch

from aiko_services_tpu_torch import serving
from aiko_services_tpu_torch.models import layers as L
from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
from aiko_services_tpu_torch.serving import ContinuousDecoder
from aiko_services_tpu_torch.serving_paged import BlockPool

CONFIG = LLAMA_PRESETS["tiny"]


def _pool(initial=4, grow=2, name="p"):
    registry = MetricsRegistry()
    return BlockPool(CONFIG, 8, False, initial_blocks=initial,
                     grow_blocks=grow, name=name, registry=registry,
                     device="cpu"), registry


def test_block_zero_is_the_null_block_and_never_allocated():
    pool, _ = _pool()
    assert pool.num_blocks == 5
    assert len(pool.k_pools) == CONFIG.num_layers
    assert pool.k_pools[0].shape == (5, CONFIG.num_kv_heads, 8,
                                     CONFIG.head_dim)
    ids = pool.alloc_blocks(4)
    assert sorted(ids) == [1, 2, 3, 4]
    assert all(not pool.k_pools[i][0].any() for i in range(2))
    assert pool.used_blocks() == 4 and pool.occupancy() == 1.0
    pool.release_blocks([0])              # the null block is not owned
    assert pool.refs(0) == 0 and pool.used_blocks() == 4


def test_growth_is_geometric_and_keeps_contents():
    pool, registry = _pool()
    first = pool.alloc_blocks(4)
    pool.k_pools[0][first[0]].fill_(1.5)
    more = pool.alloc_blocks(1)           # free list empty: grow
    assert pool.num_blocks == 9           # at least doubles: +4, not +2
    assert more == [5]
    assert torch.all(pool.k_pools[0][first[0]] == 1.5)
    assert not pool.k_pools[0][5:].any()
    assert pool.stats["grows"] == 1
    assert registry.gauge("kv_pool_blocks", labels={"pool": "p"}).value == 8
    assert registry.gauge("kv_pool_blocks_used",
                          labels={"pool": "p"}).value == 5
    pool.reserve(20)
    assert pool.num_blocks - 1 >= 20
    # the stats dict mirrors into the registry's pool-events counters
    mirrored = [metric.value for metric in registry._metrics.values()
                if metric.labels == {"pool": "p", "kind": "allocs"}]
    assert pool.stats["allocs"] == 5 and mirrored == [5]


def test_refcounts_and_release_of_a_free_block_raises():
    pool, _ = _pool()
    ids = pool.alloc_blocks(2)
    pool.retain(ids[:1])
    assert pool.refs(ids[0]) == 2
    pool.release_blocks(ids)
    assert pool.refs(ids[0]) == 1 and pool.refs(ids[1]) == 0
    assert pool.used_blocks() == 1
    with pytest.raises(ValueError, match="release of free block"):
        pool.release_blocks([ids[1]])
    with pytest.raises(ValueError, match="retain of dead block"):
        pool.retain([ids[1]])
    pool.release_blocks(ids[:1])
    assert pool.used_blocks() == 0 and pool.stats["frees"] == 2


def test_maybe_shrink_releases_the_free_tail_down_to_its_floor():
    pool, _ = _pool(initial=4, grow=4)
    ids = pool.alloc_blocks(12)           # grows 5 → 13 blocks at once
    assert pool.num_blocks == 13
    assert pool.maybe_shrink() == 0       # occupancy above the watermark
    pool.release_blocks([i for i in ids if i != 1])   # block 1 stays
    assert pool.tail_free_blocks() == 11
    released = pool.maybe_shrink()
    assert released == 8                  # down to the floor of 5, not 2
    assert pool.num_blocks == 5 and pool.k_pools[0].shape[0] == 5
    assert pool.refs(1) == 1 and pool.stats["shrinks"] == 1
    assert pool.maybe_shrink() == 0       # at the floor
    assert sorted(pool.alloc_blocks(3)) == [2, 3, 4]


def test_kv_int8_pools_raise():
    """An int8 pool holds {"q" int8, "s" f32} per layer, grows and
    shrinks both planes together, and raises on rows of the native form
    (rows must be quantized before they land in it)."""
    pool = BlockPool(CONFIG, 8, True, initial_blocks=2, grow_blocks=2,
                     device="cpu", registry=MetricsRegistry())
    leaf = pool.k_pools[0]
    assert leaf["q"].shape == (3, CONFIG.num_kv_heads, 8, CONFIG.head_dim)
    assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
    assert leaf["s"].shape == (3, CONFIG.num_kv_heads, 8)
    per_block = 2 * CONFIG.num_layers * CONFIG.num_kv_heads * 8 * (
        CONFIG.head_dim + 4)
    assert pool.nbytes() == 3 * per_block
    ids = pool.alloc_blocks(6)                       # grows 3 → 7 blocks
    assert pool.num_blocks == 7 and pool.nbytes() == 7 * per_block
    assert pool.v_pools[1]["s"].shape[0] == 7
    pool.release_blocks(ids)
    assert pool.maybe_shrink() == 4 and pool.k_pools[0]["q"].shape[0] == 3
    assert pool.v_pools[1]["s"].shape[0] == 3
    native_rows = torch.zeros((1, CONFIG.num_kv_heads, 8, CONFIG.head_dim))
    with pytest.raises(TypeError, match="differ in form"):
        L.write_paged_blocks(pool.k_pools[0], torch.tensor([[1]]),
                             native_rows)


@pytest.fixture(scope="module")
def model():
    return llama_init(torch.Generator().manual_seed(0), CONFIG,
                      device="cpu")


def _decoder(model, **kwargs):
    return ContinuousDecoder(model, CONFIG, device="cpu",
                             **{"paged_kv": True, **kwargs})


@pytest.mark.parametrize("option", [
    {"paged_kv": False},
    {"kv_cache_dtype": "int8", "speculate_k": 2},
    {"speculate_k": 2},
])
def test_dense_and_speculative_options_serve(model, option):
    decoder = _decoder(model, max_slots=2, prefill_buckets=(16,),
                       kv_block=8, **option)
    assert decoder.paged == option.get("paged_kv", True)
    assert decoder.speculate_k == option.get("speculate_k", 0)
    done = {}
    decoder.submit("r", [3, 1, 4, 1, 5], 6,
                   lambda rid, t: done.update({rid: t}))
    while not decoder.idle:
        decoder.pump()
    assert len(done["r"]) == 6
    if decoder.paged:
        assert decoder.pool.used_blocks() == 0


def test_the_dense_path_is_the_jax_default(model):
    decoder = ContinuousDecoder(model, CONFIG, device="cpu")
    assert not decoder.paged and decoder.pool is None
    assert len(decoder._k) == CONFIG.num_layers
    assert tuple(decoder._k[0].shape) == (8, CONFIG.num_kv_heads,
                                          decoder._cache_t, CONFIG.head_dim)
    assert decoder.kv_cache_bytes() == 2 * CONFIG.num_layers * \
        decoder._k[0].numel() * decoder._k[0].element_size()


@pytest.mark.parametrize("option", [
    {"paged_kv": False}, {}, {"paged_kv": False, "speculate_k": 2},
    {"speculate_k": 2}])
def test_measure_device_step_runs_the_decoders_own_round(model, option):
    decoder = _decoder(model, max_slots=2, kv_block=8, **option)
    ms = serving.measure_device_step(decoder, steps_per_sync=4, chains=2)
    assert ms > 0.0
    assert decoder.idle and decoder.stats["steps"] == 0
    with pytest.raises(ValueError, match="pass max_seq_len"):
        serving.measure_device_step(decoder,
                                    steps_per_sync=CONFIG.max_seq_len + 1)


def test_submit_normalises_prompts_and_kv_cache_bytes(model):
    decoder = _decoder(model, max_slots=2, prefill_buckets=(16,),
                       kv_block=8)
    done = {}
    decoder.submit("empty", [], 2, lambda rid, t: done.update({rid: t}))
    decoder.submit("long", list(range(1, 40)), 3,
                   lambda rid, t: done.update({rid: t}))
    assert [len(r.prompt) for r in decoder._pending] == [1, 16]
    assert decoder._pending[1].prompt[0] == 24     # the tail is kept
    before = decoder.kv_cache_bytes()
    assert before == decoder.pool.nbytes() + 2 * decoder._table_blocks * 4
    while not decoder.idle:
        decoder.pump()
    assert [len(done[r]) for r in ("empty", "long")] == [2, 3]
    assert decoder.pool.used_blocks() == 0
    assert decoder.stats["tokens_prefill"] == 17


def test_disaggregated_submit_options(model):
    """prefill_label names the TTFT / journey population, and the
    progress callback sees every prefill chunk land (its exceptions
    are logged, not raised)."""
    decoder = _decoder(model, max_slots=2, prefill_buckets=(16,),
                       prefill_chunk=16, kv_block=8)
    seen, done = [], {}

    def progress(request, finished):
        seen.append((request.prefill_pos, finished))
        raise RuntimeError("a failing callback must not stop the round")

    assert decoder.submit("r", list(range(1, 41)), 3,
                          lambda rid, t: done.update({rid: t}),
                          prefill_label="remote",
                          progress_callback=progress)
    assert decoder._pending[0].journey.prefill_label == "remote"
    while not decoder.idle:
        decoder.pump()
    assert seen == [(16, False), (32, False), (40, True)]
    assert len(done["r"]) == 3
    assert decoder.slo_sketch_stats(prefill="remote")["ttft_p50_ms"] \
        is not None
    assert decoder.slo_sketch_stats(prefill="cold")["ttft_p50_ms"] is None
