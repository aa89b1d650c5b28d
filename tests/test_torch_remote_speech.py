"""examples/speech/pipeline_transcription_remote.json, unedited, on both
packages: a caller pipeline (PE_MicrophoneSim → PE_AudioFraming →
PE_LogMel → remote_asr → PE_Speaker) whose remote_asr hop crosses the
binary wire to a serving pipeline named p_transcription_server
((PE_WhisperASR (PE_Synthesize)), behind an AdmissionGate that reads the
batch scheduler's wait estimate), found through the registrar.  Each
package runs registrar, server and caller as three runtimes on one
broker and one engine under a virtual clock.  Both serve the "test"
Whisper preset in f32 from the same seeded weights, as
tests/test_torch_speech_pipeline.py does; the caller's PE_LogMel runs on
the host.  Tokens must be equal for every (stream, frame) across the
packages with the lossless wire and with the i8mel codec, and, lossless,
equal to the local example's.  The two packages' f32 log-mels differ by ulps
(up to ~5e-5 here), which moves a few i8mel codes and each row's scale
bytes, so the i8mel run feeds both callers the same mel through a source
stub in PE_LogMel's place (the port's log-mel, a CPU tensor for the port
and a numpy array for JAX) and then holds the packed bytes equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import event as JE
from aiko_services_tpu import pipeline as JP
from aiko_services_tpu.compute import ComputeRuntime as JComputeRuntime
from aiko_services_tpu.elements.speech import save_flat_npz
from aiko_services_tpu.models import whisper as JW
from aiko_services_tpu.ops import admission as JA
from aiko_services_tpu.process import ProcessRuntime as JProcessRuntime
from aiko_services_tpu.registrar import Registrar as JRegistrar
from aiko_services_tpu.share import ServicesCache as JServicesCache
from aiko_services_tpu.transport import memory as JM
from aiko_services_tpu_torch import event as TE
from aiko_services_tpu_torch import pipeline as TP
from aiko_services_tpu_torch.bridge import load_flat_npz
from aiko_services_tpu_torch.compute import ComputeRuntime as TComputeRuntime
from aiko_services_tpu_torch.ops import admission as TA
from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram, mel_i8_pack
from aiko_services_tpu_torch.process import ProcessRuntime as TProcessRuntime
from aiko_services_tpu_torch.registrar import Registrar as TRegistrar
from aiko_services_tpu_torch.share import ServicesCache as TServicesCache
from aiko_services_tpu_torch.transport import memory as TM
from aiko_services_tpu_torch.transport import wire as TW

torch.set_num_threads(1)

REMOTE = "examples/speech/pipeline_transcription_remote.json"
LOCAL = "examples/speech/pipeline_transcription.json"
PACKAGES = {
    "jax": (JE, JM, JProcessRuntime, JP, JComputeRuntime, JRegistrar,
            JServicesCache, JA),
    "torch": (TE, TM, TProcessRuntime, TP, TComputeRuntime, TRegistrar,
              TServicesCache, TA),
}
BUCKETS = [500, 1000, 3000]
MAX_TOKENS = 24
STREAMS, FRAMES = 2, 3
# the serving pipeline's PE_WhisperASR: the local example's parameters,
# the "test" preset, and the hallucination gates opened (random weights
# give near-uniform logprobs)
ASR = {
    "PE_WhisperASR.preset": "test",
    "PE_WhisperASR.mode": "batched",
    "PE_WhisperASR.max_tokens": MAX_TOKENS,
    "PE_WhisperASR.buckets": BUCKETS,
    "PE_WhisperASR.max_wait": 0.05,
    "PE_WhisperASR.max_batch": 8,
    "PE_WhisperASR.logprob_threshold": -1e9,
    "PE_WhisperASR.compression_ratio_threshold": 1e9,
}


def server_definition(weights_path):
    return {
        "version": 0, "name": "p_transcription_server", "runtime": "jax",
        "graph": ["(PE_WhisperASR (PE_Synthesize))"],
        "parameters": {**ASR, "PE_WhisperASR.weights": weights_path},
        "elements": [
            {"name": "PE_WhisperASR", "input": [{"name": "mel"}],
             "output": [{"name": "tokens"}, {"name": "text"}]},
            {"name": "PE_Synthesize", "input": [{"name": "text"}],
             "output": [{"name": "audio"}]},
        ],
    }


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    config = dataclasses.replace(
        JW.WHISPER_PRESETS["test"], n_audio_ctx=max(BUCKETS) // 2,
        n_text_ctx=MAX_TOKENS + 8)
    params = jax.jit(functools.partial(JW.whisper_init, config=config))(
        jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("weights") / "whisper_test.npz")
    save_flat_npz(params, path)
    return params, path


def _to_f32(package, element, weights):
    if package == "jax":
        element.config = dataclasses.replace(element.config,
                                             dtype=jnp.float32)
        element.params = weights[0]
    else:
        element.config = dataclasses.replace(element.config,
                                             dtype=torch.float32)
        element.params = load_flat_npz(element.params.float(), weights[1])


def _element(pipeline, name):
    return next(node.element for node in pipeline.graph.nodes()
                if node.name == name)


def _drive(engine, done, count):
    while len(done) < count and engine.clock.now() < 30.0:
        while engine.step():
            pass
        engine.clock.advance(0.01)


def _streams(pipeline):
    for i in range(STREAMS):
        pipeline.create_stream(f"s{i}", lease_time=0, parameters={
            "PE_MicrophoneSim.frequency": 220.0 + 110.0 * i,
            "PE_MicrophoneSim.limit": FRAMES})


def mel_stub(package):
    """A PE_LogMel stand-in that gives both packages the same mel: the
    port's log-mel of the audio, as a CPU tensor for the port and as a
    numpy array for JAX."""
    module = PACKAGES[package][3]

    class PE_LogMel(module.PipelineElement):
        def process_frame(self, frame, audio=None, **_):
            mel = log_mel_spectrogram(torch.from_numpy(
                np.asarray(audio, np.float32))[None])[0]
            return module.FrameOutput(
                True, {"mel": mel if package == "torch" else mel.numpy()})
    return PE_LogMel


def run_remote(package, weights, codecs=None, stub=False):
    """The remote example on one package; returns the caller's frames,
    the server's frames, the envelopes the caller sent to the server,
    and both pipelines."""
    (event, memory, runtime_class, module, compute_class, registrar_class,
     cache_class, admission) = PACKAGES[package]
    engine = event.EventEngine(event.VirtualClock())
    broker = memory.MemoryBroker()

    def runtime(name):
        def factory(on_message, lwt_topic, lwt_payload, lwt_retain):
            return memory.MemoryMessage(
                on_message=on_message, broker=broker, lwt_topic=lwt_topic,
                lwt_payload=lwt_payload, lwt_retain=lwt_retain)
        return runtime_class(name=name, engine=engine,
                             transport_factory=factory).initialize()

    registrar_class(runtime("reg"))
    engine.clock.advance(2.1)           # past the primary search
    while engine.step():
        pass
    serve_rt = runtime("serve")
    compute = compute_class(serve_rt, "compute", **(
        {"device": "cpu"} if package == "torch" else {}))
    gate = admission.AdmissionGate(
        inflight_limit=64, metrics_labels={"pipeline": f"rs_{package}"})
    server = module.Pipeline(
        serve_rt, module.parse_pipeline_definition(
            server_definition(weights[1])),
        stream_lease_time=0, auto_create_streams=True, admission=gate)
    asr = _element(server, "PE_WhisperASR")
    asr._setup()
    _to_f32(package, asr, weights)
    gate.watch_scheduler(
        compute.programs["whisper_asr.PE_WhisperASR"].scheduler)
    served = []
    server.add_frame_handler(served.append)

    call_rt = runtime("call")
    definition = module.load_pipeline_definition(REMOTE)
    definition.parameters["PE_LogMel.device"] = "cpu"
    caller = module.Pipeline(
        call_rt, definition, services_cache=cache_class(call_rt),
        stream_lease_time=0, remote_timeout=20.0,
        remote_wire_codecs=codecs,
        element_classes={"PE_LogMel": mel_stub(package)} if stub else None)
    sent = []
    spy = memory.MemoryMessage(on_message=lambda _t, p: sent.append(p),
                               broker=broker)
    spy.connect()
    spy.subscribe(f"{server.topic_path}/in")
    while engine.step():
        pass
    assert caller.remote_elements_ready()
    done = []
    caller.add_frame_handler(done.append)
    _streams(caller)
    _drive(engine, done, STREAMS * FRAMES)
    return done, served, sent, caller, server


def run_local(weights):
    """The local example on the port, with the same streams."""
    engine = TE.EventEngine(TE.VirtualClock())
    broker = TM.MemoryBroker()
    runtime = TProcessRuntime(
        name="local", engine=engine,
        transport_factory=lambda on_message, *_: TM.MemoryMessage(
            on_message=on_message, broker=broker)).initialize()
    TComputeRuntime(runtime, "compute", device="cpu")
    definition = TP.load_pipeline_definition(LOCAL)
    definition.parameters.update(ASR, **{
        "PE_LogMel.device": "cpu", "PE_WhisperASR.weights": weights[1]})
    pipeline = TP.Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    _streams(pipeline)
    _to_f32("torch", _element(pipeline, "PE_WhisperASR"), weights)
    _drive(engine, done, STREAMS * FRAMES)
    return {(f.stream_id, f.frame_id): np.asarray(f.swag["tokens"])
            for f in done}


def mel_bytes(payloads):
    """stream id -> the i8mel bytes that crossed for its frames, in send
    order, read from the request envelopes as they crossed."""
    crossed = {}
    for payload in payloads:
        if not TW.is_envelope(payload):
            continue
        expr, buffers = TW.read_envelope(payload)
        entries = expr[1] if expr[0] == "process_frames_remote" \
            else [expr[1:]]
        for entry in entries:
            marker = entry[1]["mel"]
            assert marker[5] == "i8mel"
            crossed.setdefault(entry[0], []).append(
                bytes(buffers[int(marker[1])]))
    return crossed


def _tokens(frames):
    return {(f.stream_id, f.frame_id): np.asarray(f.swag["tokens"])
            for f in frames}


def check_remote(package_run, reference_run, wire_dtype):
    done, served, _, caller, server = package_run
    assert len(done) == STREAMS * FRAMES
    assert caller.recovery_stats["frames_failed"] == 0
    assert not caller._pending_remote
    # tokens, text and audio came back from the server, mel was elided
    # and restored from what the caller sent
    for frame in done:
        swag = frame.swag
        assert {"tokens", "text", "audio", "mel"} <= set(swag)
        assert isinstance(swag["text"], str) and swag["text"]
        assert np.asarray(swag["audio"]).size
    # the caller merged exactly what the server produced
    served_tokens = _tokens(served)
    for key, tokens in _tokens(done).items():
        np.testing.assert_array_equal(tokens, served_tokens[key])
    reference = _tokens(reference_run[0])
    assert reference.keys() == _tokens(done).keys()
    for key, tokens in _tokens(done).items():
        np.testing.assert_array_equal(tokens, reference[key])
    # every frame went through the admission gate, none was shed
    assert server.recovery_stats["shed_early"] == 0
    assert server.recovery_stats["admission_shed"] == 0
    # what the server's PE_WhisperASR received: a host array of the
    # wire's dtype (i8mel unpacks to float32 as well)
    for frame in served:
        assert isinstance(frame.swag["mel"], np.ndarray)
        assert frame.swag["mel"].dtype == wire_dtype


def test_remote_example_tokens_match_jax_and_the_local_run(weights):
    port = run_remote("torch", weights)
    reference = run_remote("jax", weights)
    check_remote(port, reference, np.float32)
    local = run_local(weights)
    for key, tokens in _tokens(port[0]).items():
        np.testing.assert_array_equal(tokens, local[key])
    # lossless wire: the server saw the caller's mel bit for bit
    sent = {(f.stream_id, f.frame_id): f.swag["mel"] for f in port[0]}
    for frame in port[1]:
        np.testing.assert_array_equal(
            frame.swag["mel"], sent[(frame.stream_id, frame.frame_id)])


def test_remote_example_with_i8mel_sends_jax_bytes(weights):
    codecs = {"mel": "i8mel"}
    port = run_remote("torch", weights, codecs, stub=True)
    reference = run_remote("jax", weights, codecs, stub=True)
    port_bytes, jax_bytes = mel_bytes(port[2]), mel_bytes(reference[2])
    assert port_bytes == jax_bytes
    # and they are mel_i8_pack of the caller's own mel
    frames = {(f.stream_id, f.frame_id): f for f in port[0]}
    for stream_id, crossed in port_bytes.items():
        for frame_id, data in enumerate(crossed):
            mel = frames[(stream_id, frame_id)].swag["mel"].numpy()
            assert data == mel_i8_pack(mel).tobytes()
    check_remote(port, reference, np.float32)
