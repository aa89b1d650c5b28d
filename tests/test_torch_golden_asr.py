"""The capability-parity gate on the port: audio in, English out, text
correct, on weights the port trained.

The module fixture trains the test-preset Whisper on the tone language
with the port on the CPU (tests/torch_golden.py, the recipe of
tests/test_speech_golden.py) and saves it with the port's
bridge.save_flat_npz.  Through the port's own Pipeline and
ComputeRuntime (PE_AudioReadFile → PE_LogMel → PE_WhisperASR, served in
bf16 as the element serves) the known wavs give "charlie alpha" and
"bravo", and int8 cross-KV gives "charlie alpha".  Parity with JAX: the
same npz through the JAX pipeline's PE_WhisperASR, both elements
switched to f32 after setup, gives the same texts and tokens on the
host-mel path, the fused µ-law frontend and int8 cross-KV.

The fused frontend computes real mel for the silence pad, where JAX's
recipe trains on zero-padded mel only, so there the fused text depends
on the init (ROADMAP Queue 3 item 19).  The port's recipe trains each
text on both inputs the served model reads (zero-padded host mel, and
the mel the fused µ-law frontend computes), so the fused µ-law gate
holds on the port's weights too: "charlie alpha" and "bravo" in bf16
(after .strip(), as JAX's gate strips), and JAX's tokens in f32.  The
same gate on the weights of JAX's own recipe (PRNGKey(0)) is
tests/test_torch_golden_fused.py's."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_golden as golden
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.bridge import load_flat_npz, save_flat_npz
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.elements.speech import save_wav
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.transport import memory as TM

torch.set_num_threads(1)

UTTERANCES = {"s0": ["charlie", "alpha"], "s1": ["bravo"]}


@pytest.fixture(scope="module")
def golden_weights(tmp_path_factory):
    """The port-trained tone Whisper as a flat npz, and its wavs."""
    directory = tmp_path_factory.mktemp("golden")
    params = golden.train_whisper(device="cpu")
    path = str(directory / "weights.npz")
    save_flat_npz(params, path)
    wavs = {}
    for sid, words in UTTERANCES.items():
        wavs[sid] = str(directory / f"{sid}.wav")
        save_wav(wavs[sid], golden.utterance(words))
    return path, wavs


def _jax_modules():
    from aiko_services_tpu import event as JE
    from aiko_services_tpu import pipeline as JP
    from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
    from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
    from aiko_services_tpu.transport import memory as JM
    return JE, JM, JProcessRuntime, JP, JComputeRuntime


def _to_f32(package, element, weights):
    """Switch a set-up ASR element to f32 on the same npz (its program
    reads config and params at its first batch)."""
    if package == "jax":
        import jax
        import jax.numpy as jnp

        from aiko_services_tpu.elements.speech import load_flat_npz as jload
        from aiko_services_tpu.models.whisper import whisper_init
        element.config = dataclasses.replace(element.config,
                                             dtype=jnp.float32)
        element.params = jload(whisper_init(jax.random.PRNGKey(0),
                                            element.config), weights)
    else:
        element.config = dataclasses.replace(element.config,
                                             dtype=torch.float32)
        element.params = load_flat_npz(element.params.float(), weights)


def transcribe(golden_weights, package="torch", frontend="mel",
               streams=("s0", "s1"), f32=False, **parameters):
    """Each stream's wav through the package's golden pipeline on a
    virtual clock: {stream id: (text, tokens)}, and the ASR element."""
    weights, wavs = golden_weights
    event, memory, runtime_class, module, compute_class = \
        _jax_modules() if package == "jax" else \
        (TE, TM, TProcessRuntime, TP, TComputeRuntime)
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()
    runtime = runtime_class(
        name=f"golden_{package}", engine=engine,
        transport_factory=lambda on_message, *_: memory.MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    compute_class(runtime, "compute",
                  **({"device": "cpu"} if package == "torch" else {}))
    definition = golden.asr_definition(weights, frontend, **parameters)
    if package == "torch":
        definition["parameters"]["PE_LogMel.device"] = "cpu"
    pipeline = module.Pipeline(
        runtime, module.parse_pipeline_definition(definition),
        stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    asr = next(node.element for node in pipeline.graph.nodes()
               if node.name == "PE_WhisperASR")
    for sid in streams:
        pipeline.create_stream(sid, lease_time=0, parameters={
            "PE_AudioReadFile.pathname": wavs[sid]})
        if f32 and sid == streams[0]:
            _to_f32(package, asr, weights)
        pipeline.post("process_frame", sid, {})
    for _ in range(400):
        if len(done) == len(streams):
            break
        engine.clock.advance(0.01)
        engine.step()
    assert len(done) == len(streams)
    return {frame.stream_id: (frame.swag["text"],
                              np.asarray(frame.swag["tokens"]).tolist())
            for frame in done}, asr


def test_fixture_config_is_the_asr_elements(golden_weights):
    """The trained model's config is what PE_WhisperASR builds for
    preset test, buckets [100] and max_tokens 14 (in bf16 there)."""
    _, asr = transcribe(golden_weights, streams=("s1",))
    assert asr.config == dataclasses.replace(golden.whisper_config(),
                                             dtype=torch.bfloat16)


def test_known_wav_transcribes_to_correct_text(golden_weights):
    """The capability-parity gate: audio in, English out, text correct."""
    texts, _ = transcribe(golden_weights)
    assert texts["s0"][0] == "charlie alpha"
    assert texts["s1"][0] == "bravo"


def test_kv_quant_preserves_golden_transcript(golden_weights):
    """int8 cross-KV does not change the trained model's transcript."""
    texts, _ = transcribe(golden_weights, streams=("s0",), kv_quant=True)
    assert texts["s0"][0].strip() == "charlie alpha"


def test_fused_mulaw_frontend_transcribes_to_correct_text(golden_weights):
    """The fused µ-law gate on the port's own weights: raw audio → µ-law
    uint8 → the fused expand + log-mel + decode, served in bf16, gives
    the golden texts (.strip(), as JAX's gate strips)."""
    texts, _ = transcribe(golden_weights, frontend="mulaw")
    assert texts["s0"][0].strip() == "charlie alpha"
    assert texts["s1"][0].strip() == "bravo"


@pytest.mark.parametrize("frontend, parameters", [
    ("mel", {}), ("mulaw", {}), ("mel", {"kv_quant": True})],
    ids=["host_mel", "mulaw", "kv_quant"])
def test_jax_pipeline_on_the_port_weights_gives_the_same_tokens(
        golden_weights, frontend, parameters):
    """The port-trained npz through both packages' pipelines in f32:
    the same texts and the same tokens."""
    streams = ("s0", "s1") if frontend == "mel" else ("s0",)
    port, _ = transcribe(golden_weights, "torch", frontend, streams,
                         f32=True, **parameters)
    reference, _ = transcribe(golden_weights, "jax", frontend, streams,
                              f32=True, **parameters)
    assert port == reference
    if frontend == "mel":
        assert port["s0"][0] == "charlie alpha"
        assert port["s1"][0] == "bravo"
    else:
        assert port["s0"][0].strip() == "charlie alpha"
