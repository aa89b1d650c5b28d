# Pipeline contract checker: prove a PipelineDefinition sound WITHOUT
# instantiating any element.
#
# PipelineGraph.validate (pipeline.py) catches the direct-predecessor
# dataflow errors at construction time; this checker goes deployment-deep:
#
#   graph-parse          definition/graph DSL does not build
#   graph-cycle          the DAG has a cycle
#   graph-unused-element element defined but absent from the graph
#   graph-unreachable    node not reachable from any graph head
#   graph-mapping        edge name-mapping references an undeclared
#                        output (source side) or input (target side)
#   graph-missing-input  an input no upstream output, head swag, or
#                        stream parameter can ever provide
#   graph-dead-output    output of a non-terminal element that nothing
#                        downstream consumes (warning)
#   graph-contract-syntax  a declared contract string does not parse
#   graph-contract       producer/consumer contracts cannot unify on an
#                        edge (dtype/shape/codec mismatch)
#   graph-codec          a wire codec hint on a remote hop is illegal
#                        for the dtype the contract says it carries
#
# Contracts come from the definition (element-level "contracts" dict or
# per-io "contract" entries) or, for local/builtin elements, from a
# class-level `contracts` attribute — resolved by IMPORT only, never by
# construction, so checking a definition has zero runtime side effects.
# Builtin classes are the port's elements; codecs are the port's wire
# (transport/wire.py), which speaks the JAX package's wire.

from __future__ import annotations

from ..pipeline import (PipelineDefinition, PipelineError, PipelineGraph,
                        load_pipeline_definition, lookup_contract)
from ..transport import wire
from ..utils.graph import GraphError
from .contracts import ContractError, compatible, parse_contract
from .findings import ERROR, WARNING, Finding

__all__ = ["check_definition", "check_pipeline_file",
           "check_wire_schemas"]

# dtype-alias inverse map for the wire-schema check: contract alts
# carry canonical numpy names; the wire runtime tables do too
_WIRE_SCHEMA_PATH = "aiko_services_tpu_torch/transport/wire.py"


def check_wire_schemas(schema=None, dtypes=None, ranks=None) -> list:
    """Prove the declared KV-transfer payload schema sound:
    every field's contract string parses under the contract grammar,
    and its declared dtypes/rank agree EXACTLY with the runtime
    legality tables encode_kv_transfer/decode_kv_transfer enforce —
    the same "declare dtype/shape" discipline the wire codecs follow
    (WIRE_CODEC_DTYPES/WIRE_CODEC_RANK), applied to the disaggregated
    KV transfer.  A drifted declaration is an ERROR: graft-check's
    self-check is the gate that keeps the wire contract and the wire
    code the same fact."""
    schema = wire.KV_TRANSFER_SCHEMA if schema is None else schema
    dtypes = wire.KV_TRANSFER_DTYPES if dtypes is None else dtypes
    ranks = wire.KV_TRANSFER_RANK if ranks is None else ranks
    findings = []

    def fail(field, message):
        findings.append(Finding(
            rule="wire-kv-schema", severity=ERROR,
            path=_WIRE_SCHEMA_PATH, line=0,
            message=f"KV_TRANSFER field {field!r}: {message}"))

    for field, text in schema.items():
        try:
            alts = parse_contract(text)
        except ContractError as exc:
            fail(field, f"contract {text!r} does not parse: {exc}")
            continue
        declared = []
        for alt in alts:
            if alt.codec:
                fail(field, f"alternative {alt} names a lossy codec; "
                            f"KV rows must cross bit-exact")
            declared.append(alt.dtype)
            rank = ranks.get(field)
            if alt.shape is None or rank is None or \
                    len(alt.shape) != rank:
                fail(field,
                     f"alternative {alt} rank "
                     f"{len(alt.shape) if alt.shape else None} != "
                     f"KV_TRANSFER_RANK {rank}")
        runtime = dtypes.get(field)
        if runtime is None:
            fail(field, "missing from KV_TRANSFER_DTYPES (declared "
                        "but never enforced)")
        elif sorted(set(declared)) != sorted(set(runtime)):
            fail(field, f"schema dtypes {sorted(set(declared))} != "
                        f"runtime table {sorted(set(runtime))}")
    for field in dtypes:
        if field not in schema:
            fail(field, "enforced at runtime but not declared in "
                        "KV_TRANSFER_SCHEMA")
    for field in ranks:
        if field not in schema:
            fail(field, "ranked at runtime but not declared in "
                        "KV_TRANSFER_SCHEMA")
    return findings


def check_pipeline_file(pathname: str, element_classes=None,
                        wire_codecs=None) -> list:
    try:
        definition = load_pipeline_definition(pathname)
    except (PipelineError, OSError, ValueError) as exc:
        return [Finding("graph-parse", ERROR, pathname, 0, str(exc))]
    return check_definition(definition, element_classes=element_classes,
                            wire_codecs=wire_codecs, source=pathname)


def _resolve_class(element_def, element_classes):
    """Find the element's implementation class without constructing it
    (imports only).  None when unresolvable (remote / unknown)."""
    if element_def.is_remote:
        return None
    local = element_def.deploy.get("local", {})
    class_name = local.get("class_name", element_def.name)
    if element_classes and class_name in element_classes:
        return element_classes[class_name]
    if "module" in local:
        try:
            from ..utils import load_class
            return load_class(local["module"], class_name)
        except Exception:
            return None
    try:
        from .. import elements as builtin
        return getattr(builtin, class_name, None)
    except Exception:       # pragma: no cover - import environment
        return None


class _Contracts:
    """Per-element contract lookup: definition first, class attribute
    fallback; parses each string once and reports syntax errors once."""

    def __init__(self, definition, element_classes, report):
        self._definition = definition
        self._element_classes = element_classes
        self._report = report
        self._raw_cache: dict[str, dict] = {}
        self._parsed: dict[tuple, object] = {}

    def _raw(self, element_name: str) -> dict:
        """Class-attribute contracts (the fallback when the definition
        declares none), resolved by import only."""
        if element_name not in self._raw_cache:
            element_def = self._definition.element(element_name)
            cls = _resolve_class(element_def, self._element_classes)
            self._raw_cache[element_name] = \
                dict(getattr(cls, "contracts", None) or {})
        return self._raw_cache[element_name]

    def get(self, element_name: str, direction: str, io_name: str):
        """Parsed alternatives for an element's input ("in") or output
        ("out") name, or None when undeclared/unparseable."""
        text = self.text(element_name, direction, io_name)
        if text is None:
            return None
        key = (element_name, direction, io_name)
        if key not in self._parsed:
            try:
                self._parsed[key] = parse_contract(text)
            except ContractError as exc:
                self._parsed[key] = None
                self._report(
                    "graph-contract-syntax", ERROR,
                    f"element {element_name}: contract for "
                    f"{direction}put {io_name!r}: {exc}")
        return self._parsed[key]

    def text(self, element_name: str, direction: str, io_name: str):
        element_def = self._definition.element(element_name)
        if element_def.contracts:
            return element_def.contract_for(io_name, direction)
        return lookup_contract(self._raw(element_name), io_name,
                               direction)


def check_definition(definition: PipelineDefinition, *,
                     element_classes=None, wire_codecs=None,
                     source: str = "") -> list:
    """Statically validate one PipelineDefinition; returns Findings."""
    findings: list = []
    where = source or f"<pipeline {definition.name}>"

    def report(rule, severity, message):
        findings.append(Finding(rule, severity, where, 0, message))

    try:
        graph = PipelineGraph.from_definition(definition)
    except (PipelineError, GraphError) as exc:
        report("graph-parse", ERROR, str(exc))
        return findings
    try:
        topo = graph.topological_order()
    except GraphError as exc:
        report("graph-cycle", ERROR, str(exc))
        return findings
    preds = graph.predecessor_map()

    # -- elements defined but never placed in the graph -------------------
    graph_names = set(graph.node_names())
    for element_def in definition.elements:
        if element_def.name not in graph_names:
            report("graph-unused-element", WARNING,
                   f"element {element_def.name} is defined but does not "
                   f"appear in the graph")

    # -- reachability from the declared head(s) ---------------------------
    reachable: set = set()
    frontier = [h for h in graph.head_names if h in graph_names]
    while frontier:
        name = frontier.pop()
        if name in reachable:
            continue
        reachable.add(name)
        frontier.extend(graph.successors(name))
    for name in graph_names - reachable:
        report("graph-unreachable", WARNING,
               f"element {name} is not reachable from graph head(s) "
               f"{graph.head_names}")

    # -- edge name-mapping validity ---------------------------------------
    for (tail, head), mapping in sorted(graph.mappings.items()):
        tail_outputs = definition.element(tail).output_names
        head_inputs = definition.element(head).input_names
        for src, dst in mapping.items():
            if src not in tail_outputs:
                report("graph-mapping", ERROR,
                       f"edge {tail}->{head}: mapping source {src!r} is "
                       f"not an output of {tail} (outputs: {tail_outputs})")
            if dst not in head_inputs:
                report("graph-mapping", ERROR,
                       f"edge {tail}->{head}: mapping target {dst!r} is "
                       f"not an input of {head} (inputs: {head_inputs})")

    # -- full swag dataflow ------------------------------------------------
    # The engine's swag is cumulative along the walk: anything a
    # topologically earlier element produced (plus the head frame's swag
    # and stream/pipeline parameters) is available.  An input neither of
    # those can supply WILL fail on the first frame.
    parameter_names = set()
    for key in definition.parameters:
        parameter_names.add(key.split(".", 1)[1] if "." in key else key)
    available = set(parameter_names)
    for node in topo:
        element_def = definition.element(node.name)
        if not preds[node.name]:
            # head node: its declared inputs arrive with the frame swag
            available |= set(element_def.input_names)
        else:
            rename = {}
            for pred in preds[node.name]:
                mapping = graph.mappings.get((pred, node.name), {})
                for src, dst in mapping.items():
                    rename[dst] = src
            for input_name in element_def.input_names:
                if input_name in available or \
                        rename.get(input_name) in available:
                    continue
                report("graph-missing-input", ERROR,
                       f"element {node.name}: input {input_name!r} is not "
                       f"produced by any upstream element, head frame "
                       f"swag, or stream parameter")
        outputs = set(element_def.output_names)
        available |= outputs
        for successor in graph.successors(node.name):
            mapping = graph.mappings.get((node.name, successor), {})
            for src, dst in mapping.items():
                if src in outputs:
                    available.add(dst)

    # -- dead outputs ------------------------------------------------------
    consumed: set = set()
    for node in topo:
        element_def = definition.element(node.name)
        rename = {}
        for pred in preds[node.name]:
            mapping = graph.mappings.get((pred, node.name), {})
            for src, dst in mapping.items():
                rename[dst] = src
        for input_name in element_def.input_names:
            consumed.add(input_name)
            consumed.add(rename.get(input_name, input_name))
    for node in topo:
        if not graph.successors(node.name):
            continue            # terminal outputs are the pipeline product
        element_def = definition.element(node.name)
        for output_name in element_def.output_names:
            aliases = {output_name}
            for successor in graph.successors(node.name):
                mapping = graph.mappings.get((node.name, successor), {})
                if output_name in mapping:
                    aliases.add(mapping[output_name])
            if not aliases & consumed:
                report("graph-dead-output", WARNING,
                       f"element {node.name}: output {output_name!r} is "
                       f"never consumed by any downstream element")

    # -- per-edge dtype/shape/codec contracts ------------------------------
    contracts = _Contracts(definition, element_classes,
                           lambda rule, sev, msg: report(rule, sev, msg))
    for node in topo:
        tail_def = definition.element(node.name)
        for successor in graph.successors(node.name):
            head_def = definition.element(successor)
            mapping = graph.mappings.get((node.name, successor), {})
            inverse = {dst: src for src, dst in mapping.items()}
            for input_name in head_def.input_names:
                src = inverse.get(input_name)
                if src is None and input_name in tail_def.output_names:
                    src = input_name
                if src is None:
                    continue        # fed by another ancestor, not this edge
                produced = contracts.get(node.name, "out", src)
                accepted = contracts.get(successor, "in", input_name)
                if not produced or not accepted:
                    continue
                if not compatible(produced, accepted):
                    report("graph-contract", ERROR,
                           f"edge {node.name}->{successor}: output "
                           f"{src!r} "
                           f"({contracts.text(node.name, 'out', src)}) "
                           f"cannot satisfy input {input_name!r} "
                           f"({contracts.text(successor, 'in', input_name)})")

    # -- wire codec legality on remote hops --------------------------------
    hints = dict(definition.parameters.get("wire_codecs") or {})
    hints.update(wire_codecs or {})
    if hints:
        _check_codecs(definition, graph, preds, contracts, hints, report)
    return findings


def _check_codecs(definition, graph, preds, contracts, hints, report):
    """Frames crossing a remote hop carry the remote element's inputs out
    and its outputs back; any of those keys with a wire codec hint must
    tag a dtype the codec can legally carry (wire.WIRE_CODEC_DTYPES)."""
    matched: set = set()
    for element_def in definition.elements:
        if not element_def.is_remote or element_def.name not in graph:
            continue
        carried = [("in", name) for name in element_def.input_names] + \
                  [("out", name) for name in element_def.output_names]
        for direction, key in carried:
            codec = hints.get(key)
            if codec is None:
                continue
            matched.add(key)
            if codec not in wire.WIRE_CODECS:
                report("graph-codec", ERROR,
                       f"remote element {element_def.name}: unknown wire "
                       f"codec {codec!r} for key {key!r} "
                       f"(known: {sorted(wire.WIRE_CODECS)})")
                continue
            alts = contracts.get(element_def.name, direction, key)
            if alts is None and direction == "in":
                # fall back to whatever the producers say they emit
                for pred in preds.get(element_def.name, []):
                    mapping = graph.mappings.get(
                        (pred, element_def.name), {})
                    inverse = {dst: src for src, dst in mapping.items()}
                    src = inverse.get(key, key)
                    alts = contracts.get(pred, "out", src)
                    if alts is not None:
                        break
            if not alts:
                continue            # no declared dtype: nothing to prove
            legal = [alt for alt in alts
                     if alt.dtype == "any" or wire.codec_legal(
                         codec, alt.dtype,
                         None if alt.shape is None else len(alt.shape))]
            if not legal:
                report("graph-codec", ERROR,
                       f"remote element {element_def.name}: wire codec "
                       f"{codec!r} cannot legally carry {key!r} "
                       f"(contract: "
                       f"{' | '.join(str(a) for a in alts)}; legal "
                       f"dtypes: "
                       f"{wire.WIRE_CODEC_DTYPES.get(codec)})")
    for key in sorted(set(hints) - matched):
        # a typo'd key silently disables compression at runtime (the
        # encoder never sees it) — exactly the misconfiguration class
        # this checker exists to catch
        report("graph-codec-unused", WARNING,
               f"wire codec hint for key {key!r} matches no input or "
               f"output of any remote element — typo, or the hop is "
               f"not remote?")
