"""The port's weight converters (aiko_services_tpu_torch/tools/
convert_llama.py, convert_whisper.py) against the repo's
tools/convert_*.py and against transformers.

Tiny RANDOM transformers models (tests/test_convert_{llama,whisper}.py's
configurations) go through both packages' converters: the flat dicts,
and the npz files their command lines write from a saved checkpoint, are
byte-equal.  The port's Llama and Whisper on the converted weights match
transformers' logits to the JAX tests' tolerances (rtol = atol = 2e-4),
which holds the layout transposes, the rotate_half → interleaved RoPE
permutation, GQA, the RMS eps and the SwiGLU order; greedy decoding
matches transformers' greedy generate; the save/load round trip through
bridge.save_flat_npz is exact."""

import os
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from aiko_services_tpu_torch.bridge import save_flat_npz  # noqa: E402
from aiko_services_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig, llama_forward, llama_greedy_decode)
from aiko_services_tpu_torch.models.whisper import (  # noqa: E402
    WhisperConfig, forward, greedy_decode_scored)
from aiko_services_tpu_torch.tools import (  # noqa: E402
    convert_llama, convert_whisper)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")

torch.set_num_threads(1)

DIM, HEADS, KV_HEADS, LAYERS, VOCAB, FFN = 64, 4, 2, 2, 128, 112
FRAMES, TEXT_CTX = 100, 24          # audio ctx 50 after the stride-2 conv
LLAMA = LlamaConfig(vocab=VOCAB, dim=DIM, ffn_dim=FFN, num_layers=LAYERS,
                    num_heads=HEADS, num_kv_heads=KV_HEADS, max_seq_len=64,
                    rope_theta=10000.0)
WHISPER = WhisperConfig(n_mels=80, n_audio_ctx=FRAMES // 2,
                        n_text_ctx=TEXT_CTX, n_vocab=VOCAB, dim=DIM,
                        num_heads=HEADS, enc_layers=LAYERS,
                        dec_layers=LAYERS, sot=VOCAB - 2, eot=VOCAB - 1)


def repo_converter(name):
    """The repo's tools/<name>.py, loaded under its own name."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def hf_llama():
    config = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=DIM, intermediate_size=FFN,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        num_key_value_heads=KV_HEADS, max_position_embeddings=64,
        rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(config)
    model.eval()
    return model


@pytest.fixture(scope="module")
def hf_whisper():
    config = transformers.WhisperConfig(
        vocab_size=VOCAB, num_mel_bins=80, d_model=DIM,
        encoder_layers=LAYERS, encoder_attention_heads=HEADS,
        decoder_layers=LAYERS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=4 * DIM, decoder_ffn_dim=4 * DIM,
        max_source_positions=FRAMES // 2, max_target_positions=TEXT_CTX,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        # default special ids sit at the 51865-vocab positions: pull
        # every one inside the tiny test vocab
        pad_token_id=0, bos_token_id=VOCAB - 3, eos_token_id=VOCAB - 1,
        decoder_start_token_id=VOCAB - 2)
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(config)
    model.eval()
    return model


def state_of(model) -> dict:
    return {k: v.detach().float().numpy()
            for k, v in model.state_dict().items()}


def flat_llama(hf_llama, module):
    return module.convert(state_of(hf_llama), num_heads=HEADS,
                          num_kv_heads=KV_HEADS)


@pytest.fixture(scope="module")
def converted(hf_llama, hf_whisper, tmp_path_factory):
    """Both checkpoints converted by the port, saved and loaded into the
    port's models on the CPU."""
    directory = tmp_path_factory.mktemp("converted")
    paths = {"llama": str(directory / "llama.npz"),
             "whisper": str(directory / "whisper.npz")}
    np.savez(paths["llama"], **flat_llama(hf_llama, convert_llama))
    np.savez(paths["whisper"], **convert_whisper.convert(state_of(hf_whisper)))
    return {"llama": convert_llama.load_llama(paths["llama"], LLAMA, "cpu"),
            "whisper": convert_whisper.load_whisper(paths["whisper"],
                                                    WHISPER, "cpu")}


def assert_byte_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        mine = np.asarray(got[key])
        assert mine.dtype == np.asarray(value).dtype, key
        assert mine.shape == np.asarray(value).shape, key
        assert np.ascontiguousarray(mine).tobytes() == \
            np.ascontiguousarray(value).tobytes(), key


def test_llama_converter_gives_the_repos_flat_dict(hf_llama):
    assert_byte_equal(flat_llama(hf_llama, convert_llama),
                      flat_llama(hf_llama, repo_converter("convert_llama")))


def test_whisper_converter_gives_the_repos_flat_dict(hf_whisper):
    state = state_of(hf_whisper)
    assert_byte_equal(convert_whisper.convert(state),
                      repo_converter("convert_whisper").convert(state))


@pytest.mark.parametrize("name", ["convert_llama", "convert_whisper"])
def test_command_lines_write_the_repos_npz(hf_llama, hf_whisper, name,
                                           tmp_path, monkeypatch):
    """Each command line on a saved checkpoint (safetensors and
    config.json, as transformers writes them) writes an npz equal to the
    repo tool's, array for array."""
    model = hf_llama if name == "convert_llama" else hf_whisper
    model.save_pretrained(str(tmp_path / "hf"))
    port = {"convert_llama": convert_llama,
            "convert_whisper": convert_whisper}[name]
    assert port.main([str(tmp_path / "hf"), str(tmp_path / "port")]) == 0
    monkeypatch.setattr(sys, "argv", [name, str(tmp_path / "hf"),
                                      str(tmp_path / "repo")])
    assert repo_converter(name).main() == 0
    with np.load(tmp_path / "port" / "weights.npz") as got, \
            np.load(tmp_path / "repo" / "weights.npz") as want:
        assert_byte_equal({k: got[k] for k in got.files},
                          {k: want[k] for k in want.files})


def test_loading_an_incomplete_npz_raises(hf_llama, tmp_path):
    flat = flat_llama(hf_llama, convert_llama)
    del flat["layers/1/up/w"]
    np.savez(tmp_path / "partial.npz", **flat)
    with pytest.raises(ValueError, match="layers/1/up/w"):
        convert_llama.load_llama(str(tmp_path / "partial.npz"), LLAMA, "cpu")


def test_converted_llama_logits_match_transformers(hf_llama, converted):
    tokens = np.array([[5, 17, 99, 3, 42, 77, 8, 1]], np.int64)
    with torch.no_grad():
        expected = hf_llama(torch.from_numpy(tokens)).logits.numpy()
        got = llama_forward(converted["llama"], LLAMA,
                            torch.from_numpy(tokens)).float().numpy()
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-4)


def test_converted_llama_greedy_matches_transformers_generate(hf_llama,
                                                             converted):
    prompt = np.array([[7, 23, 51]], np.int64)
    with torch.no_grad():
        hf_tokens = hf_llama.generate(
            torch.from_numpy(prompt), max_new_tokens=10, do_sample=False,
            pad_token_id=0)[0, prompt.shape[1]:].numpy()
    ours = llama_greedy_decode(converted["llama"], LLAMA,
                               torch.from_numpy(prompt), max_tokens=10)[0]
    assert ours.tolist() == hf_tokens.tolist()


def test_converted_whisper_logits_match_transformers(hf_whisper, converted):
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, FRAMES, 80)).astype(np.float32)
    tokens = np.array([[126, 5, 17, 99, 3, 42]], np.int64)
    with torch.no_grad():
        expected = hf_whisper(
            input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
            decoder_input_ids=torch.from_numpy(tokens)).logits.numpy()
        got = forward(converted["whisper"], WHISPER, torch.from_numpy(mel),
                      torch.from_numpy(tokens)).float().numpy()
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-4)


def test_converted_whisper_greedy_matches_transformers_generate(
        hf_whisper, converted):
    """transformers' greedy generate from <|sot|> (its begin-suppression
    ids lie outside the tiny vocabulary and are turned off) against the
    port's greedy decode, up to and including the first <|eot|>."""
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, FRAMES, 80)).astype(np.float32)
    with torch.no_grad():
        hf_tokens = hf_whisper.generate(
            input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
            max_new_tokens=8, do_sample=False,
            begin_suppress_tokens=None).numpy()
    tokens, lengths, _ = greedy_decode_scored(
        converted["whisper"], WHISPER, torch.from_numpy(mel), max_tokens=8)
    for row in range(2):
        want = hf_tokens[row].tolist()
        if want and want[0] == WHISPER.sot:     # the start token, if kept
            want = want[1:]
        if WHISPER.eot in want:
            want = want[:want.index(WHISPER.eot) + 1]
        assert tokens[row].tolist()[:len(want)] == want, row
        assert int(lengths[row]) == len([t for t in want
                                         if t != WHISPER.eot])


@pytest.mark.parametrize("name", ["llama", "whisper"])
def test_converter_roundtrips_save_load(converted, name, tmp_path):
    model = converted[name]
    path = str(tmp_path / "again.npz")
    save_flat_npz(model, path)
    loader, config = ((convert_llama.load_llama, LLAMA) if name == "llama"
                      else (convert_whisper.load_whisper, WHISPER))
    reloaded = loader(path, config, "cpu")
    for (key, a), (_, b) in zip(model.named_parameters(),
                                reloaded.named_parameters()):
        assert torch.equal(a, b), key
