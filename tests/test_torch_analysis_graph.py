# graft-check's pipeline contract checker on the port against the JAX
# package's: the contract grammar agrees on a seeded corpus, every
# bundled example pipeline gives the same findings through both
# packages' check_pipeline_file, the port's element classes carry the
# JAX elements' class-level contracts, and the definition-level lookup
# (lookup_contract / contract_for) keeps JAX's precedence.

import json
from pathlib import Path

import numpy as np
import pytest

import aiko_services_tpu.analysis as JA
import aiko_services_tpu.elements as JE
import aiko_services_tpu_torch.analysis as TA
import aiko_services_tpu_torch.elements as TE
from aiko_services_tpu.pipeline import lookup_contract as jax_lookup
from aiko_services_tpu.pipeline import \
    parse_pipeline_definition as jax_definition
from aiko_services_tpu_torch import pipeline as port_pipeline
from aiko_services_tpu_torch.transport import wire

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(str(path) for folder in ("pipeline", "speech")
                  for path in (REPO / "examples" / folder).glob("*.json"))


def _records(findings):
    return sorted((f.rule, f.severity, f.path, f.line, f.message)
                  for f in findings)


def _alt(alt):
    return (alt.codec, alt.dtype, alt.shape)


def _parse(module, text):
    try:
        return [_alt(alt) for alt in module.parse_contract(text)]
    except module.ContractError as exc:
        return ("error", str(exc))


def _contract_corpus(seed=0, count=400):
    """Contract strings drawn from the grammar's pieces (codecs, dtype
    aliases, shapes of ints and *), with a share of malformed ones."""
    rng = np.random.default_rng(seed)
    dtypes = ["f32", "f16", "bf16", "i8", "i16", "i32", "u8", "bool",
              "str", "any", "float32", "int64", "f99", ""]
    codecs = [""] + sorted(wire.WIRE_CODECS) + ["zip"]
    dims = ["*", "1", "80", "84", "3", "x", ""]
    corpus = []
    for _ in range(count):
        alts = []
        for _ in range(int(rng.integers(1, 4))):
            text = str(rng.choice(dtypes))
            codec = str(rng.choice(codecs))
            if codec and rng.random() < 0.5:
                text = f"{codec}-{text}"
            if rng.random() < 0.7:
                rank = int(rng.integers(0, 4))
                shape = ",".join(str(rng.choice(dims))
                                 for _ in range(rank))
                text += f"[{shape}]" if rng.random() < 0.95 \
                    else f"[{shape}"
            alts.append(text)
        corpus.append(" | ".join(alts))
    return corpus


def test_parse_contract_agrees_on_a_seeded_corpus():
    corpus = _contract_corpus()
    parsed = [_parse(TA, text) for text in corpus]
    assert parsed == [_parse(JA, text) for text in corpus]
    # the corpus covers both outcomes
    errors = sum(1 for result in parsed if result[0] == "error")
    assert 0 < errors < len(corpus)


def test_compatible_agrees_on_a_seeded_corpus():
    corpus = [text for text in _contract_corpus(seed=1)
              if _parse(TA, text)[0] != "error"]
    rng = np.random.default_rng(2)
    verdicts = []
    for _ in range(600):
        a, b = (corpus[int(i)] for i in rng.integers(0, len(corpus), 2))
        port = TA.compatible(TA.parse_contract(a), TA.parse_contract(b))
        assert port == JA.compatible(JA.parse_contract(a),
                                     JA.parse_contract(b)), (a, b)
        verdicts.append(port)
    assert 0 < sum(verdicts) < len(verdicts)


@pytest.mark.parametrize("pathname", EXAMPLES)
def test_bundled_example_gives_the_same_findings(pathname):
    port = _records(TA.check_pipeline_file(pathname))
    assert port == _records(JA.check_pipeline_file(pathname))


def test_examples_are_all_covered():
    assert len(EXAMPLES) >= 8


def _definition(module_parse, graph, elements):
    return module_parse({
        "version": 0, "name": "p_test", "runtime": "python",
        "graph": graph, "elements": elements, "parameters": {}})


@pytest.mark.parametrize("consumer, rules", [
    # PE_LogMel emits f32[*,80] by its class contract: an i16 consumer
    # clashes, an f32 one does not
    ("i16[*]", {"graph-contract"}),
    ("f32[*,80]", set()),
])
def test_class_contracts_resolve_like_jax(consumer, rules):
    elements = [{"name": "PE_LogMel", "input": [{"name": "audio"}],
                 "output": [{"name": "mel"}]},
                {"name": "PE_Sink",
                 "input": [{"name": "mel", "contract": consumer}]}]
    graph = ["(PE_LogMel PE_Sink)"]
    port = TA.check_definition(_definition(
        port_pipeline.parse_pipeline_definition, graph, elements))
    jax = JA.check_definition(_definition(jax_definition, graph,
                                          elements))
    assert _records(port) == _records(jax)
    assert {f.rule for f in port} == rules


def test_whisper_asr_contracts_check_its_wire_codecs():
    """A remote PE_WhisperASR hop: the element's class contract says
    which wire codecs may carry its audio input."""
    definition = {
        "version": 0, "name": "p_remote", "runtime": "python",
        "graph": ["(PE_MicrophoneSim PE_WhisperASR)"],
        "elements": [
            {"name": "PE_MicrophoneSim", "output": [{"name": "audio"}]},
            {"name": "PE_WhisperASR", "input": [{"name": "audio"}],
             "output": [{"name": "text"}],
             "contracts": {"in:audio": "f32[*] | i16[*]"},
             "deploy": {"remote": {"service_filter": {"name": "asr"}}}}],
        "parameters": {"wire_codecs": {"audio": "dct8"}}}
    port = TA.check_definition(
        port_pipeline.parse_pipeline_definition(json.loads(
            json.dumps(definition))))
    jax = JA.check_definition(jax_definition(definition))
    assert _records(port) == _records(jax)
    assert {f.rule for f in port} == {"graph-codec"}


def test_every_element_class_carries_the_jax_contracts():
    names = [name for name in dir(JE) if name.startswith("PE_")]
    assert names and all(hasattr(TE, name) for name in names)
    assert {name: getattr(TE, name).contracts for name in names} == \
        {name: getattr(JE, name).contracts for name in names}
    # the six the port had dropped
    for name in ("PE_MicrophoneSim", "PE_Speaker", "PE_AudioFraming",
                 "PE_LogMel", "PE_WhisperASR", "PE_Synthesize"):
        assert getattr(TE, name).contracts, name
    assert port_pipeline.PipelineElement.contracts == {}


def test_lookup_contract_direction_key_beats_plain_key():
    contracts = {"audio": "f32[*]", "in:audio": "i16[*]",
                 "out:mel": "f32[*,80]"}
    for name, direction in (("audio", "in"), ("audio", "out"),
                            ("mel", "out"), ("mel", "in"),
                            ("absent", "in")):
        assert port_pipeline.lookup_contract(contracts, name, direction) \
            == jax_lookup(contracts, name, direction)
    assert port_pipeline.lookup_contract(contracts, "audio", "in") == \
        "i16[*]"
    assert port_pipeline.lookup_contract(contracts, "audio", "out") == \
        "f32[*]"


def test_contract_for_reads_definition_and_io_items():
    raw = {"version": 0, "name": "p", "runtime": "python",
           "graph": ["(PE_A PE_B)"],
           "elements": [
               {"name": "PE_A",
                "output": [{"name": "x", "contract": "f32[*]"}],
                "contracts": {"x": "i8[*]"}},
               {"name": "PE_B", "input": [{"name": "x"}]}],
           "parameters": {}}
    port = port_pipeline.parse_pipeline_definition(json.loads(
        json.dumps(raw)))
    jax = jax_definition(raw)
    for element in ("PE_A", "PE_B"):
        for direction in ("in", "out"):
            assert port.element(element).contract_for("x", direction) \
                == jax.element(element).contract_for("x", direction)
    assert port.element("PE_A").contract_for("x", "out") == "f32[*]"
    assert port.element("PE_A").contract_for("x", "in") == "i8[*]"
