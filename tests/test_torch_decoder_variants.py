"""The port decoder's remaining JAX variants against the JAX package's.

* weight_quant: the port's layers.quantize_linear_tree equals JAX's
  exactly (int8 weights and f32 scales, MoE routers and 3-D expert
  weights left alone), bridge.quantized_from_numpy carries a JAX
  quantized tree across unchanged, and the W8A16 linears give JAX's
  values;
* the select KV write (AIKO_DECODE_KV=select) with each inner loop
  (AIKO_DECODE_ATTENTION two_pass / online / vpu), weight_quant and
  fuse_projections (alone, together, paged, speculative) give JAX's
  greedy tokens and counters in f32 over the cases of
  tests/test_serving.py (tests/test_torch_dense_serving.py's schedules),
  and the parameter bytes JAX counts;
* JAX's construction rules: select refuses int8, speculation and the
  paged pool; fuse_projections refuses biases.

The JAX variants are module globals fixed at import (serving.KV_WRITE,
ATTENTION_IMPL): the tests set them with monkeypatch.setattr, and the
port's environment variables with monkeypatch.setenv before
construction."""

import jax
import numpy as np
import pytest
import torch

import aiko_services_tpu.serving as JS
from aiko_services_tpu.models import layers as JLL
from aiko_services_tpu.models import llama as JL
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch import serving as TS
from aiko_services_tpu_torch.models import layers as TLL
from aiko_services_tpu_torch.models import llama as TL

from test_torch_dense_serving import (CASES, J_CONFIG, T_CONFIG, TIMINGS,
                                      drive, oracle, weights)

torch.set_num_threads(1)


def flat(tree) -> dict:
    return {"/".join(map(str, path)): leaf.detach().numpy()
            for path, leaf in TLL.tree_leaves(tree)}


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe"])
def test_quantize_linear_tree_equals_jax_exactly(preset):
    config = JL.LLAMA_PRESETS[preset]
    t_config = TL.LlamaConfig(**{name: getattr(config, name) for name in
                                 config.__dataclass_fields__})
    params = jax.jit(lambda key: JL.llama_init(key, config))(
        jax.random.PRNGKey(3))
    expected = bridge.flatten_tree(jax.tree.map(
        np.asarray, JLL.quantize_linear_tree(params)))
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     t_config, device="cpu")
    got = flat(TLL.quantize_linear_tree(model))
    assert set(got) == set(expected)
    for key, value in expected.items():
        assert got[key].dtype == value.dtype, key
        assert np.array_equal(got[key], value), key
    carried = flat(bridge.quantized_from_numpy(
        jax.tree.map(np.asarray, JLL.quantize_linear_tree(params)),
        t_config, device="cpu"))
    assert all(np.array_equal(carried[key], got[key]) for key in got)
    if preset == "tiny_moe":
        assert "layers/0/moe/router/w" in got        # routers stay whole
        assert got["layers/0/moe/w_in"].ndim == 3    # experts untouched


def test_quantized_linears_match_jax_values():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    jax_q = JLL.quantize_linear({"w": w, "b": b})
    port_q = TLL.quantize_linear({"w": torch.from_numpy(w),
                                  "b": torch.from_numpy(b)})
    assert np.array_equal(port_q["w8"].numpy(), np.asarray(jax_q["w8"]))
    assert np.array_equal(port_q["s"].numpy(), np.asarray(jax_q["s"]))
    got = TLL.linear(port_q, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JLL.linear(jax_q, x)),
                               rtol=1e-6, atol=1e-6)
    logits = TLL.linear_logits({"w8": port_q["w8"], "s": port_q["s"]},
                               torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(JLL.linear_logits(
            {"w8": jax_q["w8"], "s": jax_q["s"]}, x)), rtol=1e-6, atol=1e-6)
    # half a quantization step per channel at most
    recon = port_q["w8"].numpy().astype(np.float32) * port_q["s"].numpy()
    assert np.all(np.abs(recon - w) <= port_q["s"].numpy() * 0.51 + 1e-7)


def both(schedule, monkeypatch, kv_write="block", attention="two_pass",
         **kwargs):
    """(JAX tokens, port tokens, JAX decoder, port decoder) with the
    variant set on both sides; counters but the timings equal."""
    params, model = weights()
    monkeypatch.setattr(JS, "KV_WRITE", kv_write)
    monkeypatch.setattr(JS, "ATTENTION_IMPL", attention)
    monkeypatch.setenv("AIKO_DECODE_KV", kv_write)
    monkeypatch.setenv("AIKO_DECODE_ATTENTION", attention)
    jax_decoder = JS.ContinuousDecoder(params, J_CONFIG, **kwargs)
    port = TS.ContinuousDecoder(model, T_CONFIG, device="cpu", **kwargs)
    assert port.kv_write == kv_write and port.attention_impl == attention
    expected = drive(jax_decoder, schedule)
    result = drive(port, schedule)
    for key, value in port.stats.items():
        if key not in TIMINGS:
            assert value == jax_decoder.stats[key], key
    assert port._param_bytes == jax_decoder._param_bytes
    assert port.idle
    return expected, result, jax_decoder, port


SELECT_CASES = ("single", "concurrent", "staggered", "slot_reuse",
                "chunked_mixed")


@pytest.mark.parametrize("attention", ["two_pass", "online", "vpu"])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_kv_write_matches_jax(monkeypatch, case, attention):
    schedule, kwargs, oracles = CASES[case]()
    expected, result, _, port = both(schedule, monkeypatch, "select",
                                     attention, **kwargs)
    assert result == expected
    params, _ = weights()
    for rid, (prompt, max_new) in (oracles or {}).items():
        assert result[rid] == oracle(params, prompt, max_new), rid
    assert port.pool is None and len(port._k) == T_CONFIG.num_layers


def test_select_online_sweeps_past_one_time_block(monkeypatch):
    """A 300-position extent: the online loop runs two 256-row blocks,
    the second zero-padded."""
    schedule, kwargs, oracles = CASES["chunked"]()
    kwargs = dict(kwargs, t_block=300, max_seq=96)
    expected, result, _, port = both(schedule, monkeypatch, "select",
                                     "online", **kwargs)
    assert result == expected
    assert port._cache_t == 96
    for rid, (prompt, max_new) in oracles.items():
        assert result[rid] == oracle(weights()[0], prompt, max_new)


WEIGHT_CASES = {
    "weight_quant": {"weight_quant": True},
    "fuse": {"fuse_projections": True},
    "fuse_weight_quant": {"fuse_projections": True, "weight_quant": True},
    "weight_quant_paged": {"weight_quant": True, "paged_kv": True,
                           "kv_block": 8},
    "fuse_speculative": {"fuse_projections": True, "speculate_k": 2},
    "weight_quant_select": {"weight_quant": True},
}


@pytest.mark.parametrize("variant", list(WEIGHT_CASES))
@pytest.mark.parametrize("case", ["concurrent", "slot_reuse", "chunked"])
def test_weight_variants_match_jax(monkeypatch, variant, case):
    schedule, kwargs, oracles = CASES[case]()
    kwargs = dict(kwargs, **WEIGHT_CASES[variant])
    kv_write = "select" if variant.endswith("select") else "block"
    expected, result, jax_decoder, port = both(schedule, monkeypatch,
                                               kv_write, **kwargs)
    assert result == expected
    assert port.weight_quant == kwargs.get("weight_quant", False)
    if "fuse" in variant and not port.weight_quant:
        # fusion keeps the oracle's tokens on this geometry
        for rid, (prompt, max_new) in (oracles or {}).items():
            assert result[rid] == oracle(weights()[0], prompt, max_new)
    if port.weight_quant:
        assert port.params["layers"][0]["attn"]["q"]["w8"].dtype == \
            torch.int8
    if port.fuse_projections:
        assert "gate_up" in port.params["layers"][0]
        assert "gate" not in port.params["layers"][0]


def test_weight_quant_agrees_with_itself_across_slot_pressure(monkeypatch):
    """tests/test_serving.py:590: int8 weights move tokens off the f32
    oracle by design, so the W8 decoder is held against itself at 2 and
    6 slots, and against JAX at each."""
    prompts = {f"r{i}": [i + 3, (i * 11) % 50 + 1, 7, 2] for i in range(6)}
    schedule = {0: [(rid, prompt, 10) for rid, prompt in prompts.items()]}
    outs = {}
    for slots in (2, 6):
        expected, result, *_ = both(schedule, monkeypatch, max_slots=slots,
                                    prefill_buckets=(16,), steps_per_sync=4,
                                    weight_quant=True)
        assert result == expected
        outs[slots] = result
    assert outs[2] == outs[6]


@pytest.mark.parametrize("kwargs,match", [
    ({"kv_cache_dtype": "int8"}, "kv_cache_dtype='int8' requires"),
    ({"speculate_k": 2}, "speculate_k requires"),
    ({"paged_kv": True}, "paged_kv requires"),
])
def test_select_keeps_jax_construction_rules(monkeypatch, kwargs, match):
    monkeypatch.setenv("AIKO_DECODE_KV", "select")
    with pytest.raises(ValueError, match=match):
        TS.ContinuousDecoder(weights()[1], T_CONFIG, device="cpu", **kwargs)
    monkeypatch.setenv("AIKO_DECODE_KV", "scatter")
    with pytest.raises(ValueError, match="AIKO_DECODE_KV must be"):
        TS.ContinuousDecoder(weights()[1], T_CONFIG, device="cpu")


def test_fuse_projections_refuses_biases():
    model = weights()[1]
    tree = TLL.as_tree(model)
    tree["layers"][0]["attn"]["q"]["b"] = torch.zeros(
        T_CONFIG.num_heads * T_CONFIG.head_dim)
    with pytest.raises(ValueError, match="drops linear biases"):
        TS._fuse_decode_projections(tree)
    fused = TS._fuse_decode_projections(model)
    qkv = fused["layers"][1]["attn"]["qkv"]["w"]
    assert qkv.shape == (T_CONFIG.dim, (T_CONFIG.num_heads +
                                        2 * T_CONFIG.num_kv_heads) *
                         T_CONFIG.head_dim)
    # the tensors are the model's own, not copies, where nothing fused
    assert fused["embed"]["table"] is model.embed.table
