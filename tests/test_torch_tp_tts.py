"""PE_NeuralTTS tensor-parallel on a model axis, against the JAX package's
TTS on a virtual mesh of the same size.

Each gloo rank (tests/torch_spmd.py, rank body tests/torch_spmd_cases.py
`tp_tts`) runs the element (preset test: 64 wide, 2 layers, 4 heads,
32 tokens, 96 frames; f32, batched) in a one-element pipeline on a
ComputeRuntime over {model: 2} and {model: 4}, its weights the JAX
element's checkpoints (written by the JAX package's save_flat_npz, as
tests/test_torch_tts_element.py does).  The runtime places the acoustic
model by tts_axes: the 256-row byte embedding in vocabulary chunks, the
attention heads and the FFN's columns cut, o and mlp_out row-parallel,
mel_head and dur_head whole; the vocoder's axes cut nothing, so it stays
whole on every rank, as JAX replicates it.  The JAX reference places the
same trees by the same axes over {model: n} of the virtual CPU devices
(shard_pytree) and runs tts_forward and synthesize there.

Tolerances, f32 (those of tests/test_torch_tts.py and
tests/test_torch_tts_element.py): mel frames within 1e-4 x the
reference's largest magnitude; frame totals within 1e-4 frames; equal
sample counts; Griffin-Lim audio (4 rounds) within 2e-3 relative L2 and
the vocoder's within 1e-4 x its largest sample."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aiko_services_tpu import parallel as JP
from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.models import tts as JT
from aiko_services_tpu.models import vocoder as JV

import torch_spmd_cases as cases
from torch_spmd import run_ranks

CONFIG = JT.TTS_PRESETS["test"]
VOCODER = JV.VOCODER_PRESETS["test"]
GEOMETRIES = {"model2": {"model": 2}, "model4": {"model": 4}}
TEXTS = ["hello there", "the quick brown fox jumps over the lazy dog",
         "", "tts"]
GL_REL_L2, VOCODER_TOL, MEL_TOL, TOTAL_TOL = 2e-3, 1e-4, 1e-4, 1e-4
WAVEFORM_HOP = 160


@functools.cache
def trees():
    tts = jax.jit(functools.partial(JT.tts_init, config=CONFIG))(
        jax.random.PRNGKey(3))
    vocoder = jax.jit(functools.partial(JV.vocoder_init, config=VOCODER))(
        jax.random.PRNGKey(4))
    return tts, vocoder


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_tts")
    tts, vocoder = trees()
    save_flat_npz(tts, str(path / "tts.npz"))
    save_flat_npz(vocoder, str(path / "vocoder.npz"))
    return str(path / "tts.npz"), str(path / "vocoder.npz")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, checkpoints):
    results = run_ranks(cases.tp_tts, 4, tmp_path_factory.mktemp("tts4"),
                        {"model4": GEOMETRIES["model4"]}, *checkpoints,
                        TEXTS, timeout=240.0)
    results2 = run_ranks(cases.tp_tts, 2, tmp_path_factory.mktemp("tts2"),
                         {"model2": GEOMETRIES["model2"]}, *checkpoints,
                         TEXTS, timeout=240.0)
    out = {}
    for results_of in (results, results2):
        for key in results_of[0]:
            out[key] = [rank[key] for rank in results_of]
    return out


@functools.cache
def reference(n: int, tokens_bytes: bytes):
    """JAX's mel, totals and both legs' audio with the trees placed by
    their axes over {model: n} of the virtual devices."""
    tokens = np.frombuffer(tokens_bytes, np.int32).reshape(len(TEXTS), -1)
    mesh = JP.create_mesh({"model": n}, devices=jax.devices()[:n])
    tts, vocoder = trees()
    params = JP.shard_pytree(tts, JT.tts_axes(CONFIG), mesh)
    assert not params["blocks"][0]["mlp_in"]["w"].sharding \
        .is_fully_replicated
    vocoder = JP.shard_pytree(vocoder, JV.vocoder_axes(VOCODER), mesh)
    tokens = jnp.asarray(tokens)
    mel, total = jax.jit(functools.partial(JT.tts_forward, config=CONFIG))(
        params, tokens=tokens)
    gl = jax.jit(functools.partial(JT.synthesize, config=CONFIG,
                                   n_iter=4))(params, tokens=tokens)
    voc = jax.jit(functools.partial(
        JT.synthesize, config=CONFIG, vocoder_config=VOCODER))(
        params, tokens=tokens, vocoder=vocoder)
    return {"mel": np.asarray(mel), "total": np.asarray(total),
            "griffin_lim": _rows(gl), "vocoder": _rows(voc)}


def _rows(result):
    """The element's trim of synthesize's rows: each to its voiced
    samples, at least one hop."""
    audio, samples = (np.asarray(x) for x in result)
    return [audio[i, :max(int(samples[i]), WAVEFORM_HOP)]
            for i in range(len(TEXTS))]


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _size(geometry) -> int:
    return GEOMETRIES[geometry]["model"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_sharded_mel_and_totals_match_jax(ranks, geometry):
    for rank in ranks[(geometry, "griffin_lim")]:
        want = reference(_size(geometry), rank["tokens"].tobytes())
        scale = float(np.abs(want["mel"]).max())
        assert float(np.abs(rank["mel"] - want["mel"]).max()) <= \
            MEL_TOL * scale
        np.testing.assert_allclose(rank["total"], want["total"], rtol=0,
                                   atol=TOTAL_TOL)


@pytest.mark.parametrize("leg", ["griffin_lim", "vocoder"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_element_speaks_as_jax_on_every_rank(ranks, geometry, leg):
    tokens = ranks[(geometry, "griffin_lim")][0]["tokens"]
    want = reference(_size(geometry), tokens.tobytes())[leg]
    for rank in ranks[(geometry, leg)]:
        assert [a.size for a in rank["audio"]] == [a.size for a in want]
        for got, expected in zip(rank["audio"], want):
            if leg == "griffin_lim":
                assert _rel_l2(got, expected) <= GL_REL_L2
            else:
                assert float(np.abs(got - expected).max()) <= \
                    VOCODER_TOL * float(np.abs(expected).max())


@pytest.mark.parametrize("geometry,n", [("model2", 2), ("model4", 4)])
def test_a_rank_holds_its_heads_ffn_and_embedding_rows(ranks, geometry,
                                                       n):
    """4 heads of width 16 and an FFN of 256 columns cut n ways, the
    byte embedding's 256 rows in chunks of 256 / n; the heads whole; the
    vocoder the whole module on every rank."""
    for rank in ranks[(geometry, "griffin_lim")]:
        assert rank["embed"] == (256 // n, 64)
        assert rank["q"] == (64, 64 // n) and rank["o"] == (64 // n, 64)
        assert rank["mlp_in"] == (64, 256 // n)
        assert rank["mlp_out"] == (256 // n, 64)
        assert rank["mel_head"] == (64, CONFIG.n_mels)
        assert rank["dur_head"] == (64, 1)
    for rank in ranks[(geometry, "vocoder")]:
        assert rank["vocoder_module"]


def test_heads_that_do_not_divide_raise():
    from aiko_services_tpu_torch.models import tts as TT

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, dim=None):
            return 3

    with pytest.raises(ValueError, match="num_heads 4 does not divide"):
        TT.local_heads(TT.TTS_PRESETS["test"], Mesh())
