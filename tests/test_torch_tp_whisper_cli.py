"""examples/speech/pipeline_transcription.json through the port's CLI
with `--mesh model=2` on two gloo ranks, against the JAX package's run of
the example on the same audio.

Each rank builds the example as `pipeline create --mesh model=2 --device
cpu` builds it (cli.build_pipeline; tests/torch_spmd.py ranks, rank body
tests/torch_spmd_cases.py `tp_transcription`), from a copy naming the
ASR weights: the "test" Whisper preset (4 heads) with an odd vocabulary
of 257 (its special tokens 254 and 255 stay in range), in both
packages, so each rank holds two heads and a 129-row chunk, the last
padded.  PE_WhisperASR places its parameters by whisper_axes through
the runtime and runs its batched program tensor-parallel; its batches
are cut alike on both ranks (the runtime's agreed batch cut).  Both
packages serve one flat npz (the JAX element's model for the example's
shapes, written with save_flat_npz), switched to f32 after setup as
tests/test_torch_speech_pipeline.py does; JAX's run is its element on
one device (JAX refuses to place the odd vocabulary over two).  Two
streams of two frames each, PE_LogMel on the host.

Tolerance, f32: every (stream, frame)'s tokens and text equal JAX's, on
both ranks."""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.compute import ComputeRuntime
from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.process import ProcessRuntime
from aiko_services_tpu.transport import memory as JM

import torch_spmd_cases as cases
from torch_spmd import run_ranks

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "speech" / \
    "pipeline_transcription.json"
OVERRIDES = {
    "PE_WhisperASR.preset": "test_odd",
    "PE_WhisperASR.max_batch": 4,
    # random weights give near-uniform logprobs: open the gates
    "PE_WhisperASR.logprob_threshold": -1e9,
    "PE_WhisperASR.compression_ratio_threshold": 1e9,
    "PE_LogMel.device": "cpu",
}
STREAMS = {"PE_MicrophoneSim.limit": 2}
FREQUENCIES = [220.0, 330.0]
# the "test" preset with an odd vocabulary
PRESETS = {"test_odd": ("test", {"n_vocab": 257})}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(the definition naming the weights, the JAX params in f32)."""
    for name, (base, fields) in PRESETS.items():
        JW.WHISPER_PRESETS[name] = dataclasses.replace(
            JW.WHISPER_PRESETS[base], **fields)
    raw = json.loads(EXAMPLE.read_text())
    raw["parameters"].update(OVERRIDES)
    parameters = raw["parameters"]
    config = dataclasses.replace(
        JW.WHISPER_PRESETS["test_odd"],
        n_audio_ctx=max(parameters["PE_WhisperASR.buckets"]) // 2,
        n_text_ctx=parameters["PE_WhisperASR.max_tokens"] + 8)
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(0))
    folder = tmp_path_factory.mktemp("tp_transcription")
    npz = str(folder / "whisper_test_odd.npz")
    save_flat_npz(params, npz)
    parameters["PE_WhisperASR.weights"] = npz
    definition = folder / "pipeline_transcription.json"
    definition.write_text(json.dumps(raw))
    return str(definition), params, npz


def jax_frames(definition, params) -> dict:
    engine = JE.EventEngine(JE.VirtualClock())
    broker = JM.MemoryBroker()

    def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
        return JM.MemoryMessage(on_message=on_message, broker=broker,
                                lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                                lwt_retain=lwt_retain)

    runtime = ProcessRuntime(name="transcription", engine=engine,
                             transport_factory=transport).initialize()
    ComputeRuntime(runtime, "compute")
    pipeline = JP.Pipeline(runtime, JP.load_pipeline_definition(definition),
                           stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    for index, frequency in enumerate(FREQUENCIES):
        pipeline.create_stream(f"s{index}", lease_time=0, parameters=dict(
            STREAMS, **{"PE_MicrophoneSim.frequency": frequency}))
    asr = pipeline.graph.node("PE_WhisperASR").element
    asr.config = dataclasses.replace(asr.config, dtype=jnp.float32)
    asr.params = params
    expected = len(FREQUENCIES) * STREAMS["PE_MicrophoneSim.limit"]
    for _ in range(6000):
        if len(done) >= expected:
            break
        engine.clock.advance(0.01)
        engine.step()
    runtime.terminate()
    return {(frame.stream_id, frame.frame_id):
            (np.asarray(frame.swag["tokens"]).tolist(), frame.swag["text"])
            for frame in done}


@pytest.fixture(scope="module")
def frames(inputs, tmp_path_factory):
    definition, params, npz = inputs
    want = jax_frames(definition, params)
    ranks = run_ranks(cases.tp_transcription, 2,
                      tmp_path_factory.mktemp("tp_cli"), definition, npz,
                      STREAMS, FREQUENCIES, PRESETS, timeout=300.0)
    return want, ranks


def test_every_rank_transcribes_jax_s_tokens(frames):
    want, ranks = frames
    assert len(want) == 4 and all(tokens for tokens, _ in want.values())
    for rank in ranks:
        assert rank["frames"] == want


def test_the_asr_holds_its_shards_and_agrees_its_batches(frames):
    _, ranks = frames
    for rank in ranks:
        assert rank["mesh"] == {"model": 2}
        assert rank["q"] == (64, 32)                # 2 of 4 heads
        assert rank["table"] == (129, 64)           # ceil(257 / 2) rows
        assert rank["agreed"] and rank["batches"] >= 1
    assert ranks[0]["batches"] == ranks[1]["batches"]
