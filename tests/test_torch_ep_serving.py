"""Expert-parallel serving on the port against the JAX package's
expert-sharded decoder (tests/test_serving.py's EP test).

tiny_moe (4 experts, top 2; JAX-seeded weights, f32) served on four gloo
ranks over {expert: 4} (tests/torch_spmd.py): each rank holds one
expert's w_in / w_out (parallel.local_shards with llama_axes) and the
whole router, routes every row as the unsharded layer does (JAX's global
capacity), runs its expert and sums the combine over the expert axis.
The reference is JAX's decoder on the weights placed over {expert: 4} of
the virtual CPU devices.  Four requests on four slots, with capacity
drops.  Tolerance: tokens equal JAX's on every rank (f32; a sum of one
or two non-zero terms and zeros is exact in any order), the dropped
assignments of every FFN call equal the unsharded port decoder's, and
every rank records the same round plans.  Dense slot cache and paged
pool."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.models import moe as TM
from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
from aiko_services_tpu_torch.serving import ContinuousDecoder

import torch_spmd_cases as cases
from test_torch_paged_chunked import fresh_table_scratch
from torch_spmd import run_ranks

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny_moe"], max_seq_len=96)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
PROMPTS = {"e0": [7, 3, 21], "e1": [40, 2, 9, 9, 11], "e2": [5, 9, 23, 7],
           "e3": [17, 3, 3, 8, 100, 61, 9]}
MAX_NEW = 8
BASE = {"max_slots": 4, "prefill_buckets": (16,), "steps_per_sync": 4}
VARIANTS = {"dense": {}, "paged": {"paged_kv": True, "kv_block": 8}}


@functools.cache
def jax_params():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(4))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    return params, flat


@pytest.fixture(scope="module")
def reference():
    """variant → (JAX EP tokens, the unsharded port decoder's tokens and
    dropped assignments per FFN call)."""
    params, flat = jax_params()
    mesh = JP.create_mesh({"expert": 4}, devices=jax.devices()[:4])
    placed = JP.shard_pytree(params, JL.llama_axes(J_CONFIG), mesh)
    assert not placed["layers"][0]["moe"]["w_in"].sharding \
        .is_fully_replicated
    config = TL.LlamaConfig(**FIELDS)
    model = bridge.params_from_numpy(flat, config, device="cpu")
    out = {}
    for name, kwargs in VARIANTS.items():
        decoder = JS.ContinuousDecoder(placed, J_CONFIG, **BASE, **kwargs)
        if decoder.paged:
            fresh_table_scratch(decoder)
        want = cases._serve(decoder, PROMPTS, MAX_NEW)
        TM.drop_counts = []
        try:
            port = ContinuousDecoder(model, config, device="cpu",
                                     registry=MetricsRegistry(), **BASE,
                                     **kwargs)
            whole = cases._serve(port, PROMPTS, MAX_NEW)
            drops = [int(count) for count in TM.drop_counts]
        finally:
            TM.drop_counts = None
        out[name] = (want, whole, drops)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, flat = jax_params()
    variants = {name: {**BASE, **kwargs} for name, kwargs in VARIANTS.items()}
    return run_ranks(cases.sharded_serving, 4,
                     tmp_path_factory.mktemp("ep"), {"expert": 4}, flat,
                     FIELDS, variants, PROMPTS, MAX_NEW, timeout=240.0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ep_ranks_serve_jax_tokens_and_drop_what_unsharded_drops(
        ranks, reference, variant):
    want, whole, drops = reference[variant]
    assert whole == want
    assert sum(drops) > 0                      # top 2 of 4: drops happen
    for rank in ranks:
        assert rank[variant]["tokens"] == want
        assert rank[variant]["drops"] == drops


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ep_ranks_plan_every_round_alike(ranks, variant):
    plans = [rank[variant]["plans"] for rank in ranks]
    assert plans[0] and all(p == plans[0] for p in plans)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ep_ranks_agree_on_requests_submitted_at_other_rounds(ranks,
                                                              variant):
    """Each rank handed the requests at its own rounds and in its own
    order (torch_spmd_cases._serve_staggered) plans every round alike and
    serves the same tokens.  The capacity drops depend on which rows
    share a call, so these tokens need not be the all-at-once drive's."""
    staggered = [rank[variant]["staggered"] for rank in ranks]
    plans = [drive["plans"] for drive in staggered]
    assert plans[0] and all(p == plans[0] for p in plans)
    tokens = [drive["tokens"] for drive in staggered]
    assert len(tokens[0]) == len(PROMPTS)
    assert all(t == tokens[0] for t in tokens)


def test_each_rank_holds_one_expert_and_the_whole_router(ranks):
    for rank in ranks:
        # heads, KV heads, ffn and vocab whole; one expert of four
        assert rank["local"] == (4, 2, 128, 256, 1, 16)
        assert rank["moe_w_in"] == (1, 64, 128)
