"""The names the port's models package gained to match the JAX
package's surface, each held against its JAX counterpart on the CPU:

  - whisper.greedy_decode against JAX's greedy_decode on the same
    weights (crossed through bridge.params_from_numpy) and a seeded
    numpy mel, in f32: tokens and lengths exact, and equal to the
    port's own greedy_decode_scored;
  - moe.moe_init: JAX's moe_init tree (names, shapes, dtypes), its
    distributions (each leaf's standard deviation within 3% of JAX's
    draw at these sizes), seeded, and moe_forward on its weights equal
    to JAX's moe_forward on the same weights within 1e-6 of the
    largest magnitude;
  - models/__init__.py: every name JAX's models/__init__.py re-exports
    is the port's own object, the one its submodule defines, and
    importing the package loads no jax, click or paho."""

import ast
import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aiko_services_tpu_torch.models as TModels
from aiko_services_tpu.models import moe as JM
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu_torch import bridge
from aiko_services_tpu_torch.models import moe as TM
from aiko_services_tpu_torch.models import whisper as TW
from aiko_services_tpu_torch.ops import attention as TA
from test_torch_whisper import _mel, _pair

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def whisper_pair():
    return _pair()


@pytest.mark.parametrize("kwargs", [
    dict(max_tokens=10),
    dict(max_tokens=8, suppress_timestamps=True),
    dict(max_tokens=8, kv_quant="tensor"),
    dict(max_tokens=6, sot_sequence=(254, 3, 7)),
], ids=["plain", "no_timestamps", "kv_int8", "sot_prompt"])
def test_greedy_decode_matches_jax(whisper_pair, kwargs):
    j_config, params, t_config, model = whisper_pair
    mel = _mel(3, 120, seed=7)
    want_tokens, want_lengths = jax.jit(lambda p, m: JW.greedy_decode(
        p, j_config, m, **kwargs))(params, jnp.asarray(mel))
    tokens, lengths = TModels.greedy_decode(model, t_config,
                                            torch.from_numpy(mel), **kwargs)
    assert tokens.dtype == lengths.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_lengths))
    scored = TW.greedy_decode_scored(model, t_config, torch.from_numpy(mel),
                                     **kwargs)
    assert torch.equal(tokens, scored[0]) and torch.equal(lengths, scored[1])


def test_greedy_decode_through_the_flash_branch():
    """An encoder on the flash branch (context 1024, head dim 64), as
    chip_smoke.py's surface phase drives it: one flash dispatch per
    encoder layer and JAX's tokens."""
    j_config, params, t_config, model = _pair(dict(
        dim=128, num_heads=2, enc_layers=2, dec_layers=1,
        n_audio_ctx=1024, n_text_ctx=16))
    mel = _mel(2, 2 * 1024, seed=3)
    before = TA.dispatch_stats["flash"]
    tokens, lengths = TW.greedy_decode(model, t_config,
                                       torch.from_numpy(mel), max_tokens=6)
    assert TA.dispatch_stats["flash"] == before + 2
    want_tokens, want_lengths = jax.jit(lambda p, m: JW.greedy_decode(
        p, j_config, m, max_tokens=6))(params, jnp.asarray(mel))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_lengths))


def _moe_configs(dtype="float32"):
    sizes = dict(dim=64, ffn_dim=128, num_experts=8, top_k=2)
    return (JM.MoeConfig(**sizes, dtype=getattr(jnp, dtype)),
            TM.MoeConfig(**sizes, dtype=getattr(torch, dtype)))


def _tree(model):
    tree = {}
    for name, param in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = param.detach().float().numpy()
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_draws_the_jax_tree_and_distributions(dtype):
    j_config, t_config = _moe_configs(dtype)
    want = jax.jit(functools.partial(JM.moe_init, config=j_config))(
        jax.random.PRNGKey(0))
    model = TModels.moe_init(torch.Generator().manual_seed(0), t_config,
                             device="cpu")
    assert isinstance(model, TM.MoE)
    want_flat = bridge.flatten_tree(jax.tree.map(np.asarray, want))
    got = {name.replace(".", "/"): p for name, p in model.named_parameters()}
    assert set(got) == set(want_flat)
    for name, leaf in want_flat.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert got[name].dtype == t_config.dtype, name
        want_std = float(np.asarray(leaf, np.float32).std())
        got_std = float(got[name].float().std())
        assert abs(got_std - want_std) <= 0.03 * want_std, (name, got_std,
                                                            want_std)
    again = TM.moe_init(torch.Generator().manual_seed(0), t_config,
                        device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(a, b), name


def test_moe_forward_on_moe_init_weights_matches_jax():
    j_config, t_config = _moe_configs()
    model = TM.moe_init(torch.Generator().manual_seed(1), t_config,
                        device="cpu")
    params = jax.tree.map(jnp.asarray, _tree(model))
    x = np.random.default_rng(2).standard_normal((3, 7, 64)).astype(
        np.float32)
    want_y, want_aux = jax.jit(lambda p, v: JM.moe_forward(p, j_config, v))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        got_y, got_aux = TM.moe_forward(model, t_config, torch.from_numpy(x))
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0,
                               atol=1e-6 * np.abs(want_y).max())
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def _jax_reexports() -> dict:
    """{name: the submodule JAX's models/__init__.py imports it from}."""
    source = (ROOT / "aiko_services_tpu" / "models" / "__init__.py")
    names = {}
    for node in ast.parse(source.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                names[alias.asname or alias.name] = node.module or alias.name
    return names


def test_models_reexports_every_name_of_the_jax_models_package():
    """Each re-export is the object the port's submodule of the same
    name defines (a function or class is defined there)."""
    import importlib

    names = _jax_reexports()
    assert {"greedy_decode", "moe_init", "load_tokenizer", "synthesize",
            "init_llama_caches", "layers"} <= set(names) and len(names) >= 35
    for name, submodule in sorted(names.items()):
        module = importlib.import_module(
            f"aiko_services_tpu_torch.models.{submodule}")
        value = getattr(TModels, name)
        if name == submodule:                       # `from . import layers`
            assert value is module
            continue
        assert value is getattr(module, name), name
        if callable(value):
            assert value.__module__ == module.__name__, name


def test_reexported_presets_and_configs_match_jax():
    from aiko_services_tpu import models as JModels
    for table in ("WHISPER_PRESETS", "RESNET_PRESETS", "LLAMA_PRESETS",
                  "TTS_PRESETS"):
        assert set(getattr(TModels, table)) == set(getattr(JModels, table))
    for config in ("WhisperConfig", "ResNetConfig", "LlamaConfig",
                   "MoeConfig", "TTSConfig"):
        want = {f.name for f in dataclasses.fields(getattr(JModels, config))}
        got = {f.name for f in dataclasses.fields(getattr(TModels, config))}
        assert want <= got, (config, want - got)


def test_importing_the_models_package_loads_no_jax_click_or_paho():
    script = ("import sys\nimport aiko_services_tpu_torch.models as m\n"
              "assert m.greedy_decode and m.moe_init\n"
              "print(sorted(n for n in sys.modules if n.split('.')[0] in "
              "('jax', 'jaxlib', 'aiko_services_tpu', 'click', 'paho')))\n")
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "[]"
