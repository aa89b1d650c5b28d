"""The port's tokenizers held against the JAX package: the byte-level
alphabet, the byte tokenizer, BPE merges in rank order, special ids, the
Whisper special-token layout, vocab.json + merges.txt and HF
tokenizer.json loading from files the tests write (no vocabulary is
downloaded), and seeded random texts: the same ids and the same text
from both packages.  Then PE_WhisperASR's `tokenizer` parameter: the
transcription example at the "test" preset in f32 with
tokenizer="builtin:byte" gives text equal to JAX's for every (stream,
frame)."""

import json

import numpy as np
import pytest

from aiko_services_tpu.models import tokenizer as JT
from aiko_services_tpu_torch.models import tokenizer as TT

import test_torch_speech_pipeline as SP
from test_torch_speech_pipeline import weights  # noqa: F401  (a fixture)


def texts(count=40, seed=0):
    """Seeded texts over ASCII words, digits, punctuation, contractions
    and non-ASCII letters."""
    rng = np.random.default_rng(seed)
    pieces = ["the", " cat", "'s", " DON'T", " 1234567", "!!", " héllo",
              " 日本", "\n", "  ", "_x", " ⊕", "wörld", "?", " 42"]
    return ["".join(rng.choice(pieces, size=rng.integers(1, 12)))
            for _ in range(count)]


def write_vocab(path, extra=(), whisper=False):
    """A byte-level vocabulary with a few merges, as vocab.json and
    merges.txt; `whisper` pads it to the multilingual size so the
    Whisper special ids apply."""
    mapping = JT.byte_to_unicode()
    space = mapping[ord(" ")]
    vocab = {mapping[b]: b for b in range(256)}
    merges = [("t", "h"), ("th", "e"), (space, "c"), (space + "c", "a"),
              ("l", "l"), ("h", "e"), ("he", "ll"), *extra]
    for left, right in merges:
        vocab.setdefault(left + right, len(vocab))
    if whisper:
        for index in range(len(vocab), 50257):
            vocab[f"<pad{index}>"] = index
        vocab["<|endoftext|>"] = 50257
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


def write_hf(path, pre_tokenizer=None):
    mapping = JT.byte_to_unicode()
    vocab = {mapping[b]: b for b in range(256)}
    vocab["th"], vocab["<|eot|>"] = 256, 257
    spec = {"model": {"type": "BPE", "vocab": vocab, "merges": ["t h"]},
            "added_tokens": [{"id": 257, "content": "<|eot|>"}]}
    if pre_tokenizer is not None:
        spec["pre_tokenizer"] = pre_tokenizer
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec))
    return path


def test_alphabet_layout_and_byte_tokenizer_match_jax():
    assert TT.byte_to_unicode() == JT.byte_to_unicode()
    assert len(set(TT.byte_to_unicode().values())) == 256
    port, ref = TT.WhisperTokens(), JT.WhisperTokens()
    assert vars(port) == vars(ref) and \
        port.special_ids() == ref.special_ids()
    for text in texts():
        ids = TT.ByteTokenizer().encode(text)
        assert ids == JT.ByteTokenizer().encode(text)
        framed = [254] + ids + [255, 300]
        assert TT.ByteTokenizer().decode(framed) == \
            JT.ByteTokenizer().decode(framed)
    assert TT.load_tokenizer("builtin:byte").decode([104, 105]) == "hi"


@pytest.mark.parametrize("layout", ["files", "whisper", "hf", "llama3",
                                    "verbatim"])
def test_loaded_tokenizers_give_jax_ids_and_text(tmp_path, layout):
    if layout == "files":
        path = write_vocab(tmp_path / layout)
    elif layout == "whisper":
        path = write_vocab(tmp_path / layout, whisper=True)
    elif layout == "hf":
        path = write_hf(tmp_path / layout)
    elif layout == "llama3":
        path = write_hf(tmp_path / layout, {
            "type": "Sequence", "pretokenizers": [{
                "type": "Split", "pattern": {
                    "Regex": "(?i:'s|'t|'re|'ve|'m|'ll|'d)"
                             "|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}"}}]})
    else:
        path = write_hf(tmp_path / layout, {
            "type": "Split", "behavior": "Isolated",
            "pattern": {"Regex": "\\p{L}+|\\p{N}{1,2}|\\s+"}})
    port, ref = TT.load_tokenizer(str(path)), JT.load_tokenizer(str(path))
    assert port.special_ids == ref.special_ids
    for text in texts():
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)
        specials = sorted(port.special_ids)[:2]
        assert port.decode(ids + specials) == ref.decode(ids + specials)
    if layout == "files":
        assert port.encode("the cat") == [257, 259, ord("t")]
        assert port.decode(port.encode("héllo ⊕")) == "héllo ⊕"


def test_unsupported_tokenizer_json_fails_on_both(tmp_path):
    (tmp_path / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "Unigram"}}))
    for module in (TT, JT):
        with pytest.raises(ValueError, match="unsupported tokenizer"):
            module.load_tokenizer(str(tmp_path))


def test_transcription_text_through_the_byte_tokenizer_matches_jax(weights):
    port = SP._run("torch", weights, streams=2, frames_each=2,
                   **{"PE_WhisperASR.tokenizer": "builtin:byte"})
    reference = SP._run("jax", weights, streams=2, frames_each=2,
                        **{"PE_WhisperASR.tokenizer": "builtin:byte"})
    expected = {(f.stream_id, f.frame_id): f.swag for f in reference[0]}
    assert len(port[0]) == len(expected) == 4
    for frame in port[0]:
        jax_swag = expected[(frame.stream_id, frame.frame_id)]
        tokens = np.asarray(frame.swag["tokens"])
        np.testing.assert_array_equal(tokens, np.asarray(jax_swag["tokens"]))
        assert frame.swag["text"] == jax_swag["text"]
        # the byte tokenizer's text, not the id list the element prints
        # without one
        assert frame.swag["text"] == TT.ByteTokenizer().decode(
            [t for t in tokens.tolist()])
