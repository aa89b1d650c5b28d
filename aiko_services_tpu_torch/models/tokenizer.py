# Tokenizers: byte-level BPE (the GPT-2 scheme Whisper and Llama-2-era
# checkpoints use on disk) plus a byte-direct tokenizer for tests.
#
# The port's own copy of aiko_services_tpu/models/tokenizer.py: a
# self-contained BPE implementation that loads standard
# vocab.json/merges.txt files (or a HF tokenizer.json) from a local
# directory, with no network or external tokenizer library.  Greedy
# lowest-rank pair merging over a reversible byte→unicode alphabet (the
# byte-level variant of BPE, as GPT-2 and Whisper use it).

from __future__ import annotations

import json
import os
import re

from ..utils import get_logger

__all__ = ["BPETokenizer", "ByteTokenizer", "WhisperTokens",
           "load_tokenizer", "byte_to_unicode"]


def byte_to_unicode() -> dict:
    """Reversible byte→printable-unicode map (byte-level BPE alphabet).

    Printable ASCII + two latin-1 ranges map to themselves; the remaining
    68 bytes map to 256+n so every byte has a distinct printable symbol
    and vocab files stay valid JSON text."""
    keep = (list(range(ord("!"), ord("~") + 1)) +
            list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    mapping = {}
    next_code = 256
    for byte in range(256):
        if byte in keep:
            mapping[byte] = chr(byte)
        else:
            mapping[byte] = chr(next_code)
            next_code += 1
    return mapping


# GPT-2's pre-tokenizer split (contractions, letter runs, digit runs,
# punctuation runs, whitespace) expressed with re's unicode classes:
# [^\W\d_] ≈ \p{L}.  Merges never cross these boundaries — required for
# canonical ids vs the checkpoint's tokenizer, and it bounds the merge
# loop to one word instead of the whole text (O(w²) per word, not O(L²)).
_PRETOKENIZE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|_+|\s+(?!\S)|\s+")

# llama-3's tiktoken-style split, approximated with re's unicode
# classes: case-insensitive contractions, at most one leading
# non-letter before a letter run, digit runs broken into GROUPS OF ≤3,
# punctuation runs swallowing trailing newlines.  Ids diverge from the
# checkpoint's training tokenization if the GPT-2 split is used
# instead (digit runs and "DON'T" style contractions differ).
_PRETOKENIZE_LLAMA3 = re.compile(
    r"'(?i:s|t|re|ve|m|ll|d)"
    r"|(?:(?![\r\n])[\W_])?[^\W\d_]+"
    r"|\d{1,3}"
    r"| ?(?:[^\s\w]|_)+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)|\s+")


class BPETokenizer:
    """Byte-level BPE over a vocab dict + ranked merge list.

    encode: text → pre-token split → utf-8 bytes → unicode alphabet →
    greedy merges per pre-token → ids.
    decode: ids → tokens → bytes → utf-8 text (special ids skipped)."""

    def __init__(self, vocab: dict, merges: list, special_ids=(),
                 pretokenize=None):
        self.vocab = dict(vocab)                      # token str → id
        self.inverse = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(pair): rank
                      for rank, pair in enumerate(merges)}
        self.special_ids = set(int(i) for i in special_ids)
        self.pretokenize = pretokenize or _PRETOKENIZE
        self._b2u = byte_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}

    def _merge_word(self, symbols: list) -> list:
        while len(symbols) > 1:
            best_rank, best_i = None, None
            for i in range(len(symbols) - 1):
                rank = self.ranks.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best_rank is None or
                                         rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            symbols = (symbols[:best_i] +
                       [symbols[best_i] + symbols[best_i + 1]] +
                       symbols[best_i + 2:])
        return symbols

    def encode(self, text: str) -> list:
        ids = []
        for word in self.pretokenize.findall(text):
            symbols = [self._b2u[b] for b in word.encode("utf-8")]
            for symbol in self._merge_word(symbols):
                if symbol in self.vocab:
                    ids.append(self.vocab[symbol])
                else:   # unmergeable multi-byte run: emit per-byte ids
                    ids.extend(self.vocab[ch] for ch in symbol
                               if ch in self.vocab)
        return ids

    def decode(self, ids) -> str:
        data = bytearray()
        for token_id in ids:
            token_id = int(token_id)
            if token_id in self.special_ids:
                continue
            token = self.inverse.get(token_id)
            if token is None:
                continue
            data.extend(self._u2b.get(ch, ord("?")) for ch in token)
        return data.decode("utf-8", errors="replace")


class ByteTokenizer:
    """Id == byte value (vocab 256): the deterministic tokenizer for the
    'test' whisper preset (sot=254, eot=255 double as bytes the test
    language never uses).  Lets golden transcription tests run with no
    vocab files."""

    def __init__(self, special_ids=(254, 255)):
        self.special_ids = set(special_ids)

    def encode(self, text: str) -> list:
        return [b for b in text.encode("utf-8")
                if b not in self.special_ids]

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in ids
                     if int(i) not in self.special_ids and 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")


class WhisperTokens:
    """Special-token ids for the multilingual whisper vocabulary, derived
    from the vocab size (matches openai/whisper's layout: specials start
    right after the text vocab at 50257)."""

    def __init__(self, vocab_size: int = 51865):
        base = 50257
        self.eot = base
        self.sot = base + 1
        self.translate = base + 100 + 1
        self.transcribe = base + 100 + 2
        self.no_timestamps = base + 106
        self.timestamp_begin = base + 107
        # timestamps run to the end of the model's output space
        # (51865 for the multilingual layout), NOT just to len(vocab.json)
        self.vocab_size = vocab_size

    def special_ids(self):
        """Everything decode should skip: control tokens + timestamps."""
        return set(range(self.eot, self.vocab_size))


def load_tokenizer(path: str):
    """Load a tokenizer from a path.

    - "builtin:byte" → ByteTokenizer (test preset).
    - directory with vocab.json + merges.txt (GPT-2/whisper layout) or
      a HF tokenizer.json (llama-3 layout: model.vocab/model.merges) →
      BPETokenizer with whisper special ids skipped on decode."""
    if path == "builtin:byte":
        return ByteTokenizer()
    vocab_file = os.path.join(path, "vocab.json")
    merges_file = os.path.join(path, "merges.txt")
    tokenizer_json = os.path.join(path, "tokenizer.json")
    if not os.path.exists(vocab_file) and os.path.exists(tokenizer_json):
        return _load_hf_tokenizer_json(tokenizer_json)
    with open(vocab_file, encoding="utf-8") as handle:
        vocab = json.load(handle)
    merges = []
    with open(merges_file, encoding="utf-8") as handle:
        for line in handle:
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            parts = line.split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
    special = set()
    if len(vocab) >= 50257 or any(t.startswith("<|") for t in vocab):
        special = WhisperTokens(max(len(vocab), 51865)).special_ids()
    return BPETokenizer(vocab, merges, special)


def _load_hf_tokenizer_json(pathname: str):
    """HF `tokenizers`-format file (llama-3 checkpoints ship only this):
    the BPE vocab/merges live under model.vocab / model.merges.
    (llama-2's sentencepiece tokenizer.model is NOT supported — convert
    with HF's transformers first.)"""
    with open(pathname, encoding="utf-8") as handle:
        spec = json.load(handle)
    model = spec.get("model", {})
    if model.get("type") != "BPE" or "vocab" not in model:
        raise ValueError(
            f"{pathname}: unsupported tokenizer (model.type="
            f"{model.get('type')!r}); only HF BPE tokenizer.json works")
    vocab = model["vocab"]
    merges = []
    for merge in model.get("merges", []):
        pair = merge.split(" ") if isinstance(merge, str) else merge
        if len(pair) == 2:
            merges.append((pair[0], pair[1]))
    special = {entry["id"] for entry in spec.get("added_tokens", [])}
    # llama-3-family tokenizers split with the tiktoken pattern (digit
    # groups of ≤3 etc.) — detect it STRUCTURALLY from the Split
    # pre-tokenizer's own Regex strings (not a substring of the dumped
    # spec) so ids match what the checkpoint was trained on
    logger = get_logger("models.tokenizer")
    patterns = _split_regex_patterns(spec.get("pre_tokenizer", {}))
    pretokenize, chosen = _choose_pretokenizer(patterns)
    logger.info("%s: pre-tokenizer = %s", pathname, chosen)
    return BPETokenizer(vocab, merges, special, pretokenize=pretokenize)


def _choose_pretokenizer(patterns):
    """Best available split for the checkpoint's Split patterns:

    1. the checkpoint's OWN Isolated word-split Regex compiled with
       the `regex` module (\\p classes match tiktoken exactly) — no
       hard-coded pattern to drift from the checkpoint;
    2. the re approximation of the llama-3 tiktoken split when the
       spec looks tiktoken-ish but `regex` is unavailable;
    3. None → the GPT-2 default split.

    Returns (compiled-or-None, label)."""
    candidates = [p for p, behavior in patterns
                  if behavior in (None, "Isolated")
                  and r"\p{L}" in p
                  and not re.search(r"\((?![?])", p)]  # findall needs
    #                                  no capturing groups ^
    if candidates:
        try:
            import regex
            return (regex.compile(candidates[0]),
                    "checkpoint-split-regex")
        except Exception:                      # pragma: no cover
            pass
    if any(r"\p{N}{1," in p for p, _ in patterns):
        return _PRETOKENIZE_LLAMA3, "llama3-tiktoken(re-approx)"
    return None, "gpt2-default"


def _split_regex_patterns(node) -> list:
    """(pattern, behavior) for every Split pre-tokenizer under a HF
    pre_tokenizer spec (handles Sequence nesting:
    {"pretokenizers": [...]} and the flat Split form
    {"pattern": {"Regex": "..."}, "behavior": "Isolated"})."""
    patterns = []
    if isinstance(node, dict):
        pattern = node.get("pattern")
        if isinstance(pattern, dict) and isinstance(
                pattern.get("Regex"), str):
            patterns.append((pattern["Regex"], node.get("behavior")))
        for value in node.values():
            if isinstance(value, (dict, list)):
                patterns.extend(_split_regex_patterns(value))
    elif isinstance(node, list):
        for value in node:
            patterns.extend(_split_regex_patterns(value))
    return patterns
