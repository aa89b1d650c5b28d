"""Whisper tensor-parallel on the port against the JAX package's Whisper
on a virtual {model: 2} mesh.

Each gloo rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`tp_whisper`) serves its shards of the same JAX-seeded weights
(ComputeRuntime.place_params with whisper_axes), over {data: 2, model:
2} and {model: 4}: q, k, v and mlp_in column-parallel, the o
projections and mlp_out row-parallel, the tied embedding and head cut
into vocabulary chunks.  The config has an odd vocabulary (33, as
Whisper-small's 51,865 is odd), which the port pads to equal chunks of
ceil(33 / n) rows.  JAX refuses that split (device_put needs an even
one), so its reference places whisper_axes over {model: 2} of the
virtual CPU devices with the vocabulary replicated: its heads and FFN
are partitioned by GSPMD, its vocabulary whole.

Tolerance, f32: the teacher-forced forward's logits (gathered over the
model axis, the padding cut off), with grad off and under autograd,
agree with JAX's within 2e-5 absolute (the row-parallel sums add the
ranks' partials in another order: measured 1e-6); greedy_decode_scored's
tokens and lengths equal JAX's on every rank, its mean logprobs within
1e-5.  Three tensor-parallel SGD steps with the odd vocabulary on
{data: 2, model: 2} equal the unsharded step in the tolerances of
tests/test_torch_train.py's DP x TP steps, and a checkpoint of the
sharded state holds the 33 real rows and restores.  A rank holds its shards only, at this config and at Whisper-
small's widths: 6 of 12 heads over two ranks, 1,536 of the FFN's 3,072
columns, and ceil(51865 / 2) = 25,933 vocabulary rows."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.models import whisper as JW

import torch_spmd_cases as cases
from torch_spmd import run_ranks

J_CONFIG = JW.WhisperConfig(n_mels=8, n_audio_ctx=8, n_text_ctx=16,
                            n_vocab=33, dim=32, num_heads=4, enc_layers=2,
                            dec_layers=2, sot=31, eot=32)
FIELDS = {f.name: getattr(J_CONFIG, f.name)
          for f in dataclasses.fields(J_CONFIG)} | {"dtype": "float32"}
GEOMETRIES = {"data2_model2": {"data": 2, "model": 2},
              "model4": {"model": 4}}
_rng = np.random.default_rng(3)
MEL = _rng.standard_normal((2, 16, 8)).astype(np.float32)
TOKENS = _rng.integers(0, 33, (2, 5)).astype(np.int32)
MAX_TOKENS = 6
TRAIN_BATCH = {"mel": _rng.standard_normal((2, 16, 8)).astype(np.float32),
               "tokens": _rng.integers(0, 33, (2, 5)).astype(np.int32),
               "targets": _rng.integers(0, 33, (2, 5)).astype(np.int32)}


@functools.cache
def jax_tree():
    return jax.jit(functools.partial(JW.whisper_init, config=J_CONFIG))(
        jax.random.PRNGKey(0))


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def reference():
    """JAX's forward and greedy decode on {model: 2} of the virtual
    devices, whisper_axes placing the heads and the FFN (the vocabulary
    replicated: JAX refuses its odd split)."""
    mesh = JP.create_mesh({"model": 2}, devices=jax.devices()[:2])
    rules = JP.DEFAULT_RULES.with_overrides(vocab=None)
    params = JP.shard_pytree(jax_tree(), JW.whisper_axes(J_CONFIG), mesh,
                             rules)
    assert not params["dec_blocks"][0]["mlp_in"]["w"].sharding \
        .is_fully_replicated
    logits = jax.jit(functools.partial(JW.forward, config=J_CONFIG))(
        params, mel=MEL, tokens=TOKENS)
    decoded = jax.jit(functools.partial(
        JW.greedy_decode_scored, config=J_CONFIG,
        max_tokens=MAX_TOKENS))(params, mel=MEL)
    return {"logits": np.asarray(logits),
            "decoded": [np.asarray(x) for x in decoded]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("tp_asr")
    return run_ranks(cases.tp_whisper, 4, directory, GEOMETRIES,
                     _flat(jax_tree()), FIELDS, MEL, TOKENS, MAX_TOKENS,
                     TRAIN_BATCH, str(directory / "ckpt"), timeout=240.0)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_logits_match_jax(ranks, reference, geometry):
    for rank in ranks:
        run = rank[geometry]
        np.testing.assert_allclose(run["logits"], reference["logits"],
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(run["autograd"], reference["logits"],
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_greedy_decode_gives_jax_s_tokens(ranks, reference,
                                                  geometry):
    tokens, lengths, scores = reference["decoded"]
    assert lengths.min() > 0
    for rank in ranks:
        got_tokens, got_lengths, got_scores = rank[geometry]["decoded"]
        np.testing.assert_array_equal(got_tokens, tokens)
        np.testing.assert_array_equal(got_lengths, lengths)
        np.testing.assert_allclose(got_scores, scores, rtol=0, atol=1e-5)


@pytest.mark.parametrize("geometry,heads,chunk", [
    ("data2_model2", 2, 17), ("model4", 1, 9)])
def test_a_rank_holds_its_heads_ffn_and_vocabulary_chunk(ranks, geometry,
                                                         heads, chunk):
    """head dim 8: a rank's q and o are heads x 8 wide, its FFN 128 / n,
    its vocabulary ceil(33 / n) rows; the last rank's padding rows are
    zeros, and the logits are its chunk."""
    n = 4 // heads
    for rank in ranks:
        run = rank[geometry]
        assert run["q"] == (32, 8 * heads) and run["o"] == (8 * heads, 32)
        assert run["mlp_in"] == (32, 128 // n)
        assert run["table"] == (chunk, 32)
        assert run["chunk"] == (2, 5, chunk)
        assert run["padding"] == 0.0


def test_whisper_small_rank_holds_6_of_12_heads_and_a_half_vocabulary(
        ranks):
    for rank in ranks:
        assert rank["small"] == {"heads": 6, "q": (768, 384),
                                 "o": (384, 768), "mlp_in": (768, 1536),
                                 "mlp_out": (1536, 768),
                                 "table": (25933, 768)}


def test_odd_vocabulary_trains_tensor_parallel_like_the_unsharded_step(
        ranks):
    """Three SGD steps (lr 0.5) on {data: 2, model: 2} with the odd
    vocabulary (the step pads the last rank's 16 rows to a 17-row
    chunk): losses within rtol 1e-6 of the unsharded step's and
    parameters within atol 1e-5, the tolerances of
    tests/test_torch_train.py's DP x TP steps.  SGD moves each parameter
    by its gradient, so the parameters hold the gradients to those
    limits; Adam's first steps would move a parameter whose gradient is
    f32 rounding by a whole step (lr), whatever its sign.
    At rest the table keeps its 33 rows (DTensor's uneven chunks, 17
    and 16): the checkpoint holds exactly them, and a fresh sharded
    state restores the saved parameters."""
    for rank in ranks:
        run = rank["training"]
        np.testing.assert_allclose(run["losses"]["sharded"],
                                   run["losses"]["plain"], rtol=1e-6)
        assert run["losses"]["plain"][-1] < run["losses"]["plain"][0]
        for name, want in run["plain"].items():
            np.testing.assert_allclose(run["sharded"][name], want,
                                       rtol=1e-6, atol=1e-5, err_msg=name)
        assert run["table"] == [(33, 32)] and run["restored"]
    assert [rank["training"]["local_table"] for rank in ranks] == \
        [(17, 32), (16, 32)] * 2


def test_heads_that_do_not_divide_raise():
    """Only the vocabulary pads: 12 heads over a model axis of 8 raise,
    as JAX's placement does."""
    from aiko_services_tpu_torch.models import whisper as TW

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, dim=None):
            return 8

    with pytest.raises(ValueError, match="num_heads 12 does not divide"):
        TW.local_heads(TW.WHISPER_PRESETS["small"], Mesh())
