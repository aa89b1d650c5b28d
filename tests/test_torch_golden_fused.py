"""The fused µ-law gate of tests/test_speech_golden.py on the port's
pipeline, on the weights JAX's gate passes on.

The fixture trains the golden Whisper with JAX's own recipe
(tests/test_speech_golden.py train_whisper, PRNGKey(0)) and writes it
with the JAX package's save_flat_npz.  Through the port's Pipeline and
ComputeRuntime, served in bf16: raw audio → µ-law uint8 → the fused
expand + log-mel + decode gives "charlie alpha" after .strip() (the
fused path's real mel for the silence pad can add a trailing whitespace
token; JAX strips it too), and the host-mel and int8 cross-KV paths
give "charlie alpha" and "bravo".  The port-trained weights' gates are
tests/test_torch_golden_asr.py's."""

import pytest
import torch

import torch_golden as golden
from aiko_services_tpu_torch.elements.speech import save_wav
from test_torch_golden_asr import UTTERANCES, transcribe

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_golden_weights(tmp_path_factory):
    from aiko_services_tpu.elements.speech import save_flat_npz

    import test_speech_golden

    directory = tmp_path_factory.mktemp("jax_golden")
    path = str(directory / "weights.npz")
    save_flat_npz(test_speech_golden.train_whisper(), path)
    wavs = {}
    for sid, words in UTTERANCES.items():
        wavs[sid] = str(directory / f"{sid}.wav")
        save_wav(wavs[sid], golden.utterance(words))
    return path, wavs


def test_fused_audio_frontend_mulaw_wire_transcribes(jax_golden_weights):
    texts, _ = transcribe(jax_golden_weights, frontend="mulaw",
                          streams=("s0",))
    assert texts["s0"][0].strip() == "charlie alpha"


@pytest.mark.parametrize("parameters", [{}, {"kv_quant": True}],
                         ids=["host_mel", "kv_quant"])
def test_host_mel_paths_transcribe_jax_golden_weights(jax_golden_weights,
                                                      parameters):
    texts, _ = transcribe(jax_golden_weights, **parameters)
    assert texts["s0"][0] == "charlie alpha"
    assert texts["s1"][0] == "bravo"
