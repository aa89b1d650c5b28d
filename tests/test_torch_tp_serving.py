"""Tensor-parallel serving on the port against the JAX package's
TP-sharded decoder.

The port's ContinuousDecoder runs on gloo CPU ranks (tests/torch_spmd.py,
rank bodies in tests/torch_spmd_cases.py), each on its own shards of the
same JAX-seeded weights (parallel.local_shards with llama_axes: heads, KV
heads, ffn and vocab over the model axis, replicated over data), over
{model: 2}, {model: 4} and {data: 2, model: 2}.  The reference is the
JAX decoder on those weights placed by JAX's shard_pytree over
{data: 2, model: 4} of the virtual CPU devices (tests/test_serving.py's
TP test), which XLA partitions under GSPMD.  Llama-tiny's KV heads (2) do
not divide over four ranks, and the port refuses an uneven split where
JAX pads, so the config here has 8 heads and 4 KV heads (head dim 8).

Tolerance, f32: every rank's greedy tokens equal JAX's; where they split,
the JAX plain forward's top-2 logit gap at the first split must be under
1e-4 (the row-parallel sums add the ranks' partials in another order).
Every rank of a drive records the same round plans (digests compared
after the drive), also when each rank is handed the requests at its own
rounds and in its own order (the ranks agree each round's admissions), the ranks' dense KV bytes are the unsharded decoder's
over the model axis, llama_greedy_decode on the shards gives JAX's oracle
tokens and llama_forward's gathered logits JAX's within 2e-5, and the
sharded pick keeps the first maximal index across ranks.  This file holds
the dense slot cache, native and int8; test_torch_tp_serving_paged.py the
paged pool."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import llama as TL
from aiko_services_tpu_torch.observe.metrics import MetricsRegistry
from aiko_services_tpu_torch.serving import ContinuousDecoder

import torch_spmd_cases as cases
from test_torch_paged_chunked import fresh_table_scratch
from torch_spmd import run_ranks

torch.set_num_threads(1)

J_CONFIG = dataclasses.replace(JL.LLAMA_PRESETS["tiny"], num_heads=8,
                               num_kv_heads=4, max_seq_len=96)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
PROMPTS = {"r0": [5, 9, 23, 7], "r1": [40, 2], "r2": [17, 3, 3, 8, 100, 61, 9]}
MAX_NEW = 10
BASE = {"max_slots": 2, "prefill_buckets": (16,), "steps_per_sync": 4}
VARIANTS = {"dense": {}, "dense_int8": {"kv_cache_dtype": "int8"}}
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4},
              "data2_model2": {"data": 2, "model": 2}}
TIE_GAP = 1e-4


@functools.cache
def jax_params():
    params = jax.jit(functools.partial(JL.llama_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    return params, flat


def jax_tp_tokens(variants) -> dict:
    """variant → {request: tokens} of JAX's decoder on weights sharded
    over {data: 2, model: 4}."""
    params, _ = jax_params()
    mesh = JP.create_mesh({"data": 2, "model": 4},
                          devices=jax.devices()[:8])
    placed = JP.shard_pytree(params, JL.llama_axes(J_CONFIG), mesh)
    assert "model" in str(placed["layers"][0]["gate"]["w"].sharding.spec)
    out = {}
    for name, kwargs in variants.items():
        decoder = JS.ContinuousDecoder(placed, J_CONFIG, **BASE, **kwargs)
        if decoder.paged:
            fresh_table_scratch(decoder)
        out[name] = cases._serve(decoder, PROMPTS, MAX_NEW)
    return out


def port_ranks(variants, tmp_path_factory) -> dict:
    """geometry → [each rank's tp_case result] (two spawns: two ranks,
    then four)."""
    _, flat = jax_params()
    full = {name: {**BASE, **kwargs} for name, kwargs in variants.items()}
    out = {}
    for world, names in ((2, ("model2",)), (4, ("model4", "data2_model2"))):
        ranks = run_ranks(
            cases.tp_case, world, tmp_path_factory.mktemp(f"tp{world}"),
            {name: GEOMETRIES[name] for name in names}, flat, FIELDS, full,
            PROMPTS, MAX_NEW, np.asarray([PROMPTS["r2"]], np.int32),
            timeout=240.0)
        for name in names:
            out[name] = [rank[name] for rank in ranks]
    return out


def top2_gap(prompt, tokens) -> float:
    """The top-2 gap of JAX's plain forward's last logits after
    prompt + tokens."""
    params, _ = jax_params()
    logits = np.asarray(JL.llama_forward(
        params, J_CONFIG, jnp.asarray([prompt + tokens], jnp.int32)))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def assert_jax_tokens(got: dict, want: dict) -> None:
    """Equal tokens, or a split only where JAX's top-2 gap is a tie."""
    assert set(got) == set(want)
    for request_id, expected in want.items():
        tokens = got[request_id]
        if tokens == expected:
            continue
        split = next(i for i, (a, b) in enumerate(zip(tokens, expected))
                     if a != b)
        gap = top2_gap(PROMPTS[request_id], expected[:split])
        assert gap < TIE_GAP, (request_id, tokens, expected, gap)


@pytest.fixture(scope="module")
def reference():
    return jax_tp_tokens(VARIANTS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return port_ranks(VARIANTS, tmp_path_factory)


def check_serving(ranks, reference, geometry, variant):
    for rank in ranks[geometry]:
        assert_jax_tokens(rank[variant]["tokens"], reference[variant])


def check_lockstep(ranks, geometry, variants):
    for variant in variants:
        plans = [rank[variant]["plans"] for rank in ranks[geometry]]
        assert plans[0] and all(p == plans[0] for p in plans), variant


def check_staggered(ranks, reference, geometry, variants):
    """The ranks were handed the requests at other rounds and in other
    orders (torch_spmd_cases._serve_staggered): they agreed each round's
    admissions, so every rank planned every round alike and served
    JAX's tokens."""
    for variant in variants:
        staggered = [rank[variant]["staggered"] for rank in ranks[geometry]]
        plans = [drive["plans"] for drive in staggered]
        assert plans[0] and all(p == plans[0] for p in plans), variant
        for drive in staggered:
            assert_jax_tokens(drive["tokens"], reference[variant])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_tp_ranks_serve_jax_tokens(ranks, reference, geometry, variant):
    check_serving(ranks, reference, geometry, variant)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_tp_ranks_plan_every_round_alike(ranks, geometry):
    check_lockstep(ranks, geometry, VARIANTS)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_tp_ranks_agree_on_requests_submitted_at_other_rounds(
        ranks, reference, geometry):
    check_staggered(ranks, reference, geometry, VARIANTS)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_decoder_refuses_what_each_rank_would_time(ranks, geometry):
    """A request id queued twice cannot be agreed by id: it is refused.
    Drain, a submit deadline, a host tier and an AdmissionGate watching
    the decoder are agreed in the round note (rank 0 decides) and raise
    nothing; shipped KV blocks are served (submit's kv_blocks, each rank
    handing over its own heads of the blocks, installed in one round):
    the request admits on the shipped cover, prefills only its suffix
    and gives the tokens of the same prompt served cold, every rank's
    installed rows byte-equal to its heads of the shipped rows."""
    runs = ranks[geometry]
    n = GEOMETRIES[geometry]["model"]
    for rank in runs:
        refusals = rank["refusals"]
        assert "queued already" in refusals["duplicate"]
        assert set(refusals) == {"drain", "deadline", "duplicate",
                                 "host_tier", "watch_decoder"}
        for agreed in ("drain", "deadline", "host_tier", "watch_decoder"):
            assert refusals[agreed] is None, refusals
        shipped = rank["shipped"]
        assert shipped["tokens"] == shipped["cold"]
        assert len(shipped["tokens"]) == MAX_NEW
        assert shipped["covered"] == 16 and shipped["hit"] == 16
        assert shipped["rows_equal"]
        assert shipped["heads"][1] - shipped["heads"][0] == 4 // n
        assert shipped["plans"] == runs[0]["shipped"]["plans"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_ranks_hold_their_share_of_every_width(ranks, geometry):
    """Each rank's config and KV bytes are its share: heads, KV heads,
    ffn and vocab over the model axis, head dim the model's; the dense
    KV bytes the unsharded decoder's over the model axis."""
    n = GEOMETRIES[geometry]["model"]
    _, flat = jax_params()
    config = TL.LlamaConfig(**FIELDS)
    model = bridge.params_from_numpy(flat, config, device="cpu")
    whole = {}
    for variant, kwargs in VARIANTS.items():
        decoder = ContinuousDecoder(model, config, device="cpu",
                                    registry=MetricsRegistry(), **BASE,
                                    **kwargs)
        cases._serve(decoder, PROMPTS, MAX_NEW)
        whole[variant] = decoder.kv_cache_bytes()
    for rank in ranks[geometry]:
        assert rank["local"] == (8 // n, 4 // n, 128 // n, 256 // n, 0, 8)
        for variant in VARIANTS:
            assert rank[variant]["config"] == (8 // n, 4 // n)
            assert rank[variant]["kv_bytes"] * n == whole[variant]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_greedy_decode_and_forward_match_jax(ranks, geometry):
    params, _ = jax_params()
    prompt = jnp.asarray([PROMPTS["r2"]], jnp.int32)
    oracle = np.asarray(jax.jit(functools.partial(
        JL.llama_greedy_decode, config=J_CONFIG, max_tokens=MAX_NEW))(
        params, prompt=prompt))
    logits = np.asarray(JL.llama_forward(params, J_CONFIG, prompt))
    for rank in ranks[geometry]:
        greedy = rank["greedy"]
        assert_jax_tokens({"r2": greedy["tokens"][0].tolist()},
                          {"r2": oracle[0].tolist()})
        np.testing.assert_allclose(greedy["logits"], logits, rtol=2e-5,
                                   atol=2e-5)
        # the first maximal index over the whole vocabulary
        assert greedy["ties"].tolist() == [1, 1]


def test_local_config_refuses_an_uneven_split():
    """Llama-tiny's 2 KV heads over a model axis of 4: JAX pads, the
    port refuses."""
    from aiko_services_tpu_torch.parallel.sharding import local_config

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, dim=None):
            return 4

    tiny = TL.LLAMA_PRESETS["tiny"]
    with pytest.raises(ValueError, match="num_kv_heads 2 does not divide"):
        local_config(tiny, Mesh())
    local = local_config(TL.LlamaConfig(**FIELDS), Mesh())
    assert (local.num_heads, local.num_kv_heads, local.head_dim) == \
        (2, 1, 8)


def test_8b_rank_budget_equals_jax_s_plan():
    """The 8B agent's plan at TP 8, 32 slots x 2,048 positions, bf16: the
    port's per-rank weight and KV bytes (llama_rank_budget, a meta-device
    tree) equal the arithmetic of the JAX package's _lower_8b_agent
    (__graft_entry__.py) over jax.eval_shape's shapes; nothing is
    materialised or lowered at 8B."""
    slots, seq, tp = 32, 2048, 8
    jconfig = dataclasses.replace(JL.LLAMA_PRESETS["8b"], dtype=jnp.bfloat16,
                                  max_seq_len=seq)
    shapes = jax.eval_shape(lambda key: JL.llama_init(key, jconfig),
                            jax.random.PRNGKey(0))
    model_axes = {"heads", "kv_heads", "ffn", "vocab"}
    weight = [0]

    def count(leaf, axes):
        split = tp if axes is not None and any(a in model_axes
                                               for a in axes) else 1
        weight[0] += int(np.prod(leaf.shape)) * \
            jnp.dtype(leaf.dtype).itemsize // split

    jax.tree.map(count, shapes, JL.llama_axes(jconfig),
                 is_leaf=lambda x: x is None)
    kv = (2 * jconfig.num_layers * slots * (jconfig.num_kv_heads // tp) *
          seq * jconfig.head_dim * 2)
    config = TL.LlamaConfig(**{f.name: getattr(jconfig, f.name)
                               for f in dataclasses.fields(jconfig)})
    budget = TL.llama_rank_budget(config, {"model": tp}, slots, seq)
    assert budget == {"weight_bytes": weight[0], "kv_bytes": kv}
    assert budget["weight_bytes"] == 2008031232      # 16.06 GB / 8
    assert budget["kv_bytes"] == 1 << 30
