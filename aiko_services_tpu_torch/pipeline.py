# Pipeline framework: a dataflow DAG of PipelineElements processing streams
# of frames.
#
# The port's own copy of the local part of aiko_services_tpu/pipeline.py:
#   * JSON pipeline definition — version / name / runtime / graph DSL /
#     parameters / per-element definitions (the loader accepts the JAX
#     package's runtimes as they are, so its example definitions load
#     unedited);
#   * PipelineGraph — Graph + dataflow validation: every declared element
#     input must be produced by a predecessor output or renamed through an
#     explicit fan-in edge mapping;
#   * PipelineElement — create_frame / get_parameter / process_frame /
#     start_stream / stop_stream; every element is an Actor;
#   * Streams — leased lifecycles with per-stream parameters; frames extend
#     the lease; expiry destroys the stream; a per-stream failure budget;
#   * per-frame metrics: per-element and cumulative wall time stamped into
#     the frame (time_<element>, time_pipeline);
#   * deferred frames: an element that submitted work to a batching
#     scheduler returns DEFERRED and resumes the frame later through
#     pipeline.post("resume_frame", ...).
# Frames carry a "swag" dict whose values may be torch tensors on the
# card: co-located elements hand tensors to each other with no copy.
# Remote elements (remote hops, the binary wire, retries, admission) are
# not ported yet: a definition that deploys one raises
# NotImplementedError naming the ROADMAP.md item that brings them.

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable

from .actor import Actor
from .lease import Lease
from .observe import tracing
from .observe.metrics import MirroredStats
from .service import ServiceProtocol
from .utils import Graph, get_logger, load_class

__all__ = [
    "PROTOCOL_PIPELINE", "PipelineDefinition", "PipelineElementDefinition",
    "PipelineGraph", "PipelineElement", "Pipeline", "Stream", "Frame",
    "FrameOutput", "DEFERRED", "parse_pipeline_definition",
    "load_pipeline_definition", "definition_to_dict", "PipelineError",
    "REMOTE_NOT_PORTED",
]

PROTOCOL_PIPELINE = ServiceProtocol("pipeline")
DEFINITION_VERSION = 0
STREAM_LEASE_TIME = 60.0          # reference: pipeline.py:128
DEFAULT_STREAM_ID = "*"
REMOTE_NOT_PORTED = ("remote pipeline elements (remote hops, the binary "
                     "wire and admission) are not ported yet "
                     "(ROADMAP.md Queue 1 item 1)")


class PipelineError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Definition schema
# ---------------------------------------------------------------------------

@dataclass
class PipelineElementDefinition:
    """One element in a pipeline definition.

    deploy is either local —  {"local": {"module": ..., "class_name": ...}}
    — or remote — {"remote": {"service_filter": {...}}} (reference:
    pipeline.py:156-173).

    contracts maps io names to dtype/shape/codec contract strings, e.g.
    {"audio": "f32[*] | mulaw-u8[*]"} ("in:"/"out:" prefixes for
    direction-specific ones), declared here or per io item ({"name":
    "audio", "contract": "f32[*]"}).  The port validates and keeps them
    so definitions round-trip; the JAX package's static checker reads
    them."""
    name: str
    input: list = field(default_factory=list)    # [{"name":..,"type":..}]
    output: list = field(default_factory=list)
    parameters: dict = field(default_factory=dict)
    deploy: dict = field(default_factory=dict)
    contracts: dict = field(default_factory=dict)

    @property
    def input_names(self) -> list[str]:
        return [item["name"] for item in self.input]

    @property
    def output_names(self) -> list[str]:
        return [item["name"] for item in self.output]

    @property
    def is_remote(self) -> bool:
        return "remote" in self.deploy


@dataclass
class PipelineDefinition:
    version: int
    name: str
    runtime: str
    graph: list                    # list of graph-DSL strings
    parameters: dict = field(default_factory=dict)
    elements: list = field(default_factory=list)

    def element(self, name: str) -> PipelineElementDefinition:
        for element in self.elements:
            if element.name == name:
                return element
        raise PipelineError(f"no element definition: {name}")


_RUNTIMES = ("python", "jax", "tpu")


def parse_pipeline_definition(data: dict,
                              source: str = "<dict>") -> PipelineDefinition:
    """Validate + build a PipelineDefinition from a parsed JSON dict.

    Explicit structural validation replacing the reference's embedded Avro
    schema (reference: pipeline.py:512-589, :753-866)."""
    def fail(msg):
        raise PipelineError(f"pipeline definition {source}: {msg}")

    if not isinstance(data, dict):
        fail("top level must be an object")
    for key in ("version", "name", "runtime", "graph", "elements"):
        if key not in data:
            fail(f"missing required field {key!r}")
    if data["version"] != DEFINITION_VERSION:
        fail(f"version must be {DEFINITION_VERSION}, got {data['version']!r}")
    if data["runtime"] not in _RUNTIMES:
        fail(f"runtime must be one of {_RUNTIMES}, got {data['runtime']!r}")
    graph = data["graph"]
    if isinstance(graph, str):
        graph = [graph]
    if not isinstance(graph, list) or not graph or \
            not all(isinstance(g, str) for g in graph):
        fail("graph must be a non-empty list of DSL strings")
    parameters = data.get("parameters", {})
    if not isinstance(parameters, dict):
        fail("parameters must be an object")

    elements = []
    seen = set()
    for index, raw in enumerate(data["elements"]):
        where = f"elements[{index}]"
        if not isinstance(raw, dict) or "name" not in raw:
            fail(f"{where}: must be an object with a name")
        name = raw["name"]
        if name in seen:
            fail(f"{where}: duplicate element name {name!r}")
        seen.add(name)
        contracts = raw.get("contracts", {})
        if not isinstance(contracts, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in contracts.items()):
            fail(f"{where}.contracts: must map io names to contract "
                 f"strings")
        contracts = dict(contracts)
        for io_key, prefix in (("input", "in:"), ("output", "out:")):
            for io_item in raw.get(io_key, []):
                if not isinstance(io_item, dict) or "name" not in io_item:
                    fail(f"{where}.{io_key}: entries need a name")
                if "contract" in io_item:
                    if not isinstance(io_item["contract"], str):
                        fail(f"{where}.{io_key}: contract must be a "
                             f"string")
                    contracts.setdefault(prefix + io_item["name"],
                                         io_item["contract"])
        deploy = raw.get("deploy", {})
        if deploy:
            if set(deploy) - {"local", "remote"} or len(deploy) != 1:
                fail(f"{where}.deploy: exactly one of local|remote")
            if "local" in deploy and "class_name" not in deploy["local"]:
                fail(f"{where}.deploy.local: needs class_name")
            if "remote" in deploy and "service_filter" not in deploy["remote"]:
                fail(f"{where}.deploy.remote: needs service_filter")
        elements.append(PipelineElementDefinition(
            name=name,
            input=list(raw.get("input", [])),
            output=list(raw.get("output", [])),
            parameters=dict(raw.get("parameters", {})),
            deploy=dict(deploy),
            contracts=contracts))

    return PipelineDefinition(
        version=data["version"], name=data["name"], runtime=data["runtime"],
        graph=graph, parameters=dict(parameters), elements=elements)


def definition_to_dict(definition: PipelineDefinition) -> dict:
    """Inverse of parse_pipeline_definition: a plain dict that
    round-trips through parse (and through json/yaml files — the
    reference CLI's `--dump yaml/json` export, reference
    cli.py:219-231).  Empty optional fields are elided so the dump
    matches a hand-written definition."""
    elements = []
    for element in definition.elements:
        raw = {"name": element.name}
        if element.input:
            raw["input"] = list(element.input)
        if element.output:
            raw["output"] = list(element.output)
        if element.parameters:
            raw["parameters"] = dict(element.parameters)
        if element.deploy:
            raw["deploy"] = dict(element.deploy)
        if element.contracts:
            raw["contracts"] = dict(element.contracts)
        elements.append(raw)
    data = {"version": definition.version, "name": definition.name,
            "runtime": definition.runtime, "graph": list(definition.graph),
            "elements": elements}
    if definition.parameters:
        data["parameters"] = dict(definition.parameters)
    return data


def load_pipeline_definition(pathname: str) -> PipelineDefinition:
    """Load a definition from JSON or (by extension) YAML — the dump
    export round-trips through either format."""
    with open(pathname) as f:
        if pathname.endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError as exc:      # pragma: no cover
                raise PipelineError(
                    f"{pathname}: .yaml definitions need pyyaml "
                    f"(pip install pyyaml)") from exc
            data = yaml.safe_load(f)
        else:
            data = json.load(f)
    return parse_pipeline_definition(data, source=pathname)


# ---------------------------------------------------------------------------
# Graph with dataflow validation
# ---------------------------------------------------------------------------

class PipelineGraph(Graph):
    """Pipeline DAG: nodes carry elements; edges may carry name mappings
    "(PE_1 (PE_2 (a: x)))" meaning PE_1's output `a` feeds PE_2's input `x`
    (reference mapping capture: pipeline.py:418-427)."""

    def __init__(self):
        super().__init__()
        # (tail, head) -> {producer_output_name: consumer_input_name}
        self.mappings: dict[tuple[str, str], dict] = {}

    @classmethod
    def from_definition(cls,
                        definition: PipelineDefinition) -> "PipelineGraph":
        graph = cls()

        def capture(tail, head, properties):
            graph.mappings[(tail, head)] = dict(properties)

        parsed = Graph.traverse(definition.graph, capture)
        graph._nodes = parsed._nodes
        graph._head_names = parsed._head_names
        # re-key captured properties (traverse stores them on nodes too)
        for node in graph.nodes():
            for head, properties in node.properties.items():
                graph.mappings.setdefault((node.name, head),
                                          dict(properties))
        for name in graph.node_names():
            definition.element(name)        # every node must be defined
        return graph

    def validate(self, definition: PipelineDefinition) -> None:
        """Every element input must be satisfiable: produced upstream under
        the same name, renamed onto it by an edge mapping, or provided by
        the stream swag for head nodes (reference: pipeline.py:230-260)."""
        preds = self.predecessor_map()
        for node in self.topological_order():
            element_def = definition.element(node.name)
            if not preds[node.name]:
                continue        # head node: inputs come from the frame swag
            available: set[str] = set()
            for pred in preds[node.name]:
                pred_outputs = definition.element(pred).output_names
                mapping = self.mappings.get((pred, node.name), {})
                for output_name in pred_outputs:
                    available.add(mapping.get(output_name, output_name))
            missing = [name for name in element_def.input_names
                       if name not in available]
            if missing:
                raise PipelineError(
                    f"element {node.name}: inputs {missing} not produced by "
                    f"predecessors {preds[node.name]} (add an edge mapping?)")


# ---------------------------------------------------------------------------
# Streams and frames
# ---------------------------------------------------------------------------

@dataclass
class Stream:
    """A leased sequence of frames flowing through the pipeline."""
    stream_id: str
    parameters: dict = field(default_factory=dict)
    frame_id: int = 0
    state: str = "run"              # run | stop
    lease: Lease | None = None
    variables: dict = field(default_factory=dict)   # element scratch space
    consecutive_failures: int = 0   # frame failures since the last success
    last_diagnostic: str = ""       # why the most recent frame failed
    parked: list = field(default_factory=list)      # DEFERRED frames

    def next_frame_id(self) -> int:
        frame_id = self.frame_id
        self.frame_id += 1
        return frame_id


@dataclass(eq=False)        # identity semantics: Stream.parked removal
class Frame:
    """One unit of work: stream context + named values ("swag")."""
    stream: Stream
    frame_id: int
    swag: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)
    deferred_at: int | None = None      # topo index parked at (batching)
    deferred_since: float = 0.0
    # trace position + end-to-end deadline: set from the ambient context
    # or minted fresh when the pipeline has a frame_deadline
    trace: "tracing.TraceContext | None" = None

    @property
    def stream_id(self) -> str:
        return self.stream.stream_id


class _Deferred:
    """Sentinel: element submitted async work (e.g. to a batching
    scheduler) and will call pipeline.resume_frame(frame, name, outputs)
    when it completes.  Return `FrameOutput(True, DEFERRED)`."""

    def __repr__(self):
        return "DEFERRED"


DEFERRED = _Deferred()


class FrameOutput:
    """Element result: ok + named outputs.  `outputs=None` with ok=True means
    "frame consumed" (sink / windowing elements that emit nothing)."""
    __slots__ = ("ok", "outputs", "diagnostic")

    def __init__(self, ok: bool, outputs: dict | None = None,
                 diagnostic: str = ""):
        self.ok = ok
        self.outputs = outputs
        self.diagnostic = diagnostic

    def __iter__(self):     # allow  ok, outputs = element.process_frame(...)
        yield self.ok
        yield self.outputs


# ---------------------------------------------------------------------------
# PipelineElement
# ---------------------------------------------------------------------------

class PipelineElement(Actor):
    """One stage of a pipeline.  Subclasses implement process_frame and may
    implement start_stream / stop_stream (reference: pipeline.py:270-338).

    Elements whose compute runs on the card should build it once in
    __init__ or start_stream and call it in process_frame — process_frame
    itself is host-side control code."""

    def __init__(self, runtime, name, definition: PipelineElementDefinition,
                 pipeline: "Pipeline | None" = None, protocol=None,
                 tags=None):
        share = {"element": definition.name,
                 "inputs": ",".join(definition.input_names),
                 "outputs": ",".join(definition.output_names)}
        super().__init__(runtime, name,
                         protocol or ServiceProtocol("pipeline_element"),
                         tags, share=share)
        self.definition = definition
        self.pipeline = pipeline
        for key, value in definition.parameters.items():
            self.ec_producer.update(f"parameter.{key}", value)

    # -- parameters: stream > element > pipeline (reference: :316-329) ------
    def get_parameter(self, name: str, default=None, stream: Stream = None):
        if stream is not None:
            # specific beats general at every level
            scoped = f"{self.definition.name}.{name}"
            if scoped in stream.parameters:
                return stream.parameters[scoped], True
            if name in stream.parameters:
                return stream.parameters[name], True
        if name in self.definition.parameters:
            return self.definition.parameters[name], True
        if self.pipeline is not None:
            pipeline_params = self.pipeline.definition.parameters
            # specific beats general: "{element}.{name}" before bare "{name}"
            scoped = f"{self.definition.name}.{name}"
            if scoped in pipeline_params:
                return pipeline_params[scoped], True
            if name in pipeline_params:
                return pipeline_params[name], True
        return default, False

    # -- stream lifecycle ---------------------------------------------------
    def start_stream(self, stream: Stream) -> None:
        pass

    def stop_stream(self, stream: Stream) -> None:
        pass

    def process_frame(self, frame: Frame, **inputs) -> FrameOutput:
        raise NotImplementedError

    # -- source API: push a new frame into the owning pipeline --------------
    def create_frame(self, stream: Stream, swag: dict) -> None:
        """Thread-safe: posts a process_frame message onto the pipeline's
        mailbox."""
        if self.pipeline is not None:
            self.pipeline.post("process_frame", stream.stream_id, swag)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

class Pipeline(PipelineElement):
    """The pipeline engine.  A Pipeline is-a PipelineElement, so pipelines
    nest.

    Frame walk: topological DAG order; each element's declared inputs are
    gathered from the swag (applying fan-in renames), process_frame invoked,
    outputs renamed per fan-out mapping and merged back into the swag, and
    per-element wall time recorded.
    """

    def __init__(self, runtime, definition: PipelineDefinition,
                 name: str | None = None, definition_pathname: str = "",
                 element_classes: dict | None = None,
                 stream_lease_time: float = STREAM_LEASE_TIME,
                 auto_create_streams: bool = False,
                 stream_failure_budget: int = 1,
                 frame_deadline: float = 0.0):
        remote = [e.name for e in definition.elements if e.is_remote]
        if remote:
            raise NotImplementedError(
                f"pipeline {definition.name}: elements {remote}: "
                f"{REMOTE_NOT_PORTED}")
        self._element_classes = element_classes or {}
        self.graph = PipelineGraph.from_definition(definition)
        self.graph.validate(definition)
        super().__init__(
            runtime, name or definition.name,
            PipelineElementDefinition(name=definition.name),
            pipeline=None, protocol=PROTOCOL_PIPELINE,
            tags=[f"definition={definition_pathname}"] if definition_pathname
                 else None)
        # the Actor base stored the element-level definition; a Pipeline's
        # own definition is the pipeline-level one (it has .parameters too,
        # so get_parameter's fallback chain terminates here)
        self.element_definition = self.definition
        self.definition = definition
        self.pipeline = self        # parameter resolution terminates here
        self.logger = get_logger(f"pipeline.{self.name}")
        self.stream_lease_time = stream_lease_time
        self.auto_create_streams = auto_create_streams
        self.streams: dict[str, Stream] = {}
        self._frame_handlers: list[Callable] = []
        # stream_failure_budget consecutive frame failures stop a stream
        # (1: the first failure destroys it)
        self.stream_failure_budget = max(1, int(stream_failure_budget))
        # frame_deadline > 0 stamps every NEW frame with an end-to-end
        # deadline (engine-clock seconds) in its trace context
        self.frame_deadline = max(0.0, float(frame_deadline))
        # increments mirror into the process-wide metrics registry
        self.recovery_stats = MirroredStats(
            {"frames_failed": 0, "streams_stopped": 0},
            metric="pipeline_recovery_total",
            help="pipeline recovery machinery events by kind",
            labels={"pipeline": self.name})
        self._create_elements()
        self._precompute_schedule()
        self.ec_producer.update("element_count", len(self.graph))
        self.ec_producer.update("stream_count", 0)

    # -- element construction ------------------------------------------------
    def _create_elements(self) -> None:
        for node in self.graph.nodes():
            node.element = self._instantiate(
                self.definition.element(node.name))

    def _instantiate(self, element_def) -> PipelineElement:
        local = element_def.deploy.get("local", {})
        class_name = local.get("class_name", element_def.name)
        if class_name in self._element_classes:
            element_class = self._element_classes[class_name]
        elif "module" in local:
            element_class = load_class(local["module"], class_name)
        else:
            from . import elements as _builtin
            element_class = getattr(_builtin, class_name, None)
            if element_class is None:
                raise PipelineError(
                    f"element {element_def.name}: class {class_name} not in "
                    f"element_classes, no deploy.local.module given, and not "
                    f"a built-in element")
        return element_class(self.runtime, f"{self.name}.{element_def.name}",
                             element_def, pipeline=self)

    def _precompute_schedule(self) -> None:
        """Freeze the per-frame walk: graph + definition are immutable after
        construction, so topo order, predecessor/rename maps and element
        definitions are computed once, not per frame."""
        self._topo_nodes = self.graph.topological_order()
        preds = self.graph.predecessor_map()
        self._element_defs = {node.name: self.definition.element(node.name)
                              for node in self._topo_nodes}
        # per-node: declared input name -> name as produced upstream
        self._renames: dict[str, dict[str, str]] = {}
        for node in self._topo_nodes:
            rename = {}
            for pred in preds[node.name]:
                mapping = self.graph.mappings.get((pred, node.name), {})
                for src, dst in mapping.items():
                    rename[dst] = src
            self._renames[node.name] = rename

    # -- stream lifecycle ----------------------------------------------------
    def create_stream(self, stream_id, parameters: dict | None = None,
                      lease_time: float | None = None) -> Stream:
        stream_id = str(stream_id)
        if stream_id in self.streams:
            raise PipelineError(f"stream exists: {stream_id}")
        stream = Stream(stream_id=stream_id,
                        parameters=dict(parameters or {}))
        lease_time = lease_time if lease_time is not None \
            else self.stream_lease_time
        if lease_time > 0:
            stream.lease = Lease(
                self.runtime.event, lease_time, stream_id,
                lease_expired_handler=lambda _id:
                    self.destroy_stream(stream_id))
        self.streams[stream_id] = stream
        self.ec_producer.update("stream_count", len(self.streams))
        try:
            for node in self._topo_nodes:
                node.element.start_stream(stream)
        except Exception as exc:
            # don't leave a half-initialized stream registered
            self.destroy_stream(stream_id)
            raise PipelineError(
                f"pipeline {self.name}: start_stream({stream_id}) failed in "
                f"element {node.name}: {exc!r}") from exc
        return stream

    def destroy_stream(self, stream_id) -> None:
        stream = self.streams.pop(str(stream_id), None)
        if stream is None:
            return
        stream.state = "stop"
        if stream.lease is not None:
            stream.lease.cancel()
        # frames still parked DEFERRED resume into a stopped stream and
        # are dropped there (resume_frame)
        stream.parked = []
        for node in self._topo_nodes:
            try:
                node.element.stop_stream(stream)
            except Exception:
                self.logger.exception(
                    "pipeline %s: %s.stop_stream(%s) raised", self.name,
                    node.name, stream_id)
        self.ec_producer.update("stream_count", len(self.streams))

    def add_frame_handler(self, handler: Callable) -> None:
        """handler(frame) after every completed frame (tests, sinks,
        benchmark harnesses)."""
        self._frame_handlers.append(handler)

    # -- frame engine ----------------------------------------------------------
    def process_frame(self, frame_or_stream_id, swag: dict | None = None,
                      **_kwargs) -> FrameOutput:
        """Dual interface: called with (Frame, **inputs) when nested as an
        element, or with (stream_id, swag) via the actor mailbox."""
        if isinstance(frame_or_stream_id, Frame):
            # nested as an element: isolate the walk on a swag copy so a
            # nested failure or scratch value never mutates the parent frame;
            # the declared-output filter below returns only our interface
            parent = frame_or_stream_id
            stream = parent.stream
            child_swag = dict(parent.swag)
            child_swag.update(_kwargs)      # fan-in renamed inputs
            frame = Frame(stream=stream, frame_id=parent.frame_id,
                          swag=child_swag, metrics=parent.metrics,
                          trace=parent.trace)
        else:
            stream = self.streams.get(str(frame_or_stream_id))
            if stream is None:
                # "*" always auto-creates; named streams only with
                # auto_create_streams — leased, so orphaned streams expire
                if str(frame_or_stream_id) == DEFAULT_STREAM_ID:
                    stream = self.create_stream(DEFAULT_STREAM_ID,
                                                lease_time=0)
                elif self.auto_create_streams:
                    stream = self.create_stream(str(frame_or_stream_id))
                else:
                    self.logger.warning("pipeline %s: frame for unknown "
                                        "stream %s dropped", self.name,
                                        frame_or_stream_id)
                    return FrameOutput(False, diagnostic="unknown stream")
            # trace context: the ambient one when the frame arrives under
            # a caller's context, else a fresh root — with this
            # pipeline's end-to-end deadline when configured
            context = tracing.current_trace()
            if context is None and (self.frame_deadline > 0
                                    or tracing.tracer.enabled):
                deadline = None
                if self.frame_deadline > 0:
                    deadline = self.runtime.event.clock.now() + \
                        self.frame_deadline
                context = tracing.new_trace(deadline=deadline)
            frame = Frame(stream=stream, frame_id=stream.next_frame_id(),
                          swag=dict(swag or {}), trace=context)
        if stream.lease is not None:
            stream.lease.extend()

        frame.metrics["time_pipeline_start"] = time.perf_counter()
        # the walk runs under the frame's trace context: elements and
        # nested pipelines inherit it ambiently
        with tracing.activate(frame.trace):
            return self._walk(frame, 0)

    def resume_frame(self, frame: Frame, node_name: str,
                     outputs: dict | None) -> FrameOutput:
        """Continue a frame parked by a DEFERRED element (continuous
        batching: the element submitted work to a scheduler and calls this
        — typically via `pipeline.post("resume_frame", ...)` — when the
        batch completes)."""
        if frame.stream.state == "stop":
            # the stream died while the frame was parked (failure budget,
            # lease expiry, shutdown): drop the resume quietly
            return FrameOutput(False, diagnostic="stream stopped")
        if frame in frame.stream.parked:
            frame.stream.parked.remove(frame)
        index = frame.deferred_at
        if index is None:
            return FrameOutput(False, diagnostic="frame not deferred")
        node = self._topo_nodes[index]
        if node.name != node_name:
            return FrameOutput(
                False, diagnostic=f"deferred at {node.name}, "
                                  f"resumed as {node_name}")
        frame.deferred_at = None
        frame.metrics[f"time_{node.name}"] = \
            time.perf_counter() - frame.deferred_since
        # the deferred element's span covers park → resume (the wait IS
        # where the frame's budget went: batch formation + device time)
        self._record_call_span(node_name, frame, frame.deferred_since,
                               frame.metrics[f"time_{node.name}"],
                               deferred=True)
        if isinstance(outputs, Exception):
            self._fail_frame(frame, node.name, repr(outputs))
            return FrameOutput(False,
                               diagnostic=f"{node.name}: {outputs!r}")
        if outputs:
            self._merge_outputs(node, self._element_defs[node.name],
                                outputs, frame.swag)
        with tracing.activate(frame.trace):
            return self._walk(frame, index + 1)

    def _record_call_span(self, node_name: str, frame: Frame,
                          started: float, duration: float,
                          deferred: bool = False) -> None:
        """Per-element span under the frame's trace."""
        trc = tracing.tracer
        if not trc.enabled or frame.trace is None:
            return
        args = {"stream": frame.stream.stream_id,
                "frame": frame.frame_id}
        if deferred:
            args["deferred"] = True
        trc.record(f"call:{node_name}", started, duration,
                   context=frame.trace, cat="element", proc=self.name,
                   span_id=tracing.new_span_id(), args=args)

    def _walk(self, frame: Frame, start_index: int) -> FrameOutput:
        swag = frame.swag
        for index in range(start_index, len(self._topo_nodes)):
            node = self._topo_nodes[index]
            element = node.element
            element_def = self._element_defs[node.name]
            inputs = self._gather_inputs(node.name, element_def, swag)
            if inputs is None:
                self._fail_frame(frame, node.name,
                                 "missing inputs in swag")
                return FrameOutput(False,
                                   diagnostic=f"{node.name}: missing inputs")
            element_start = time.perf_counter()
            try:
                result = element.process_frame(frame, **inputs)
            except Exception as exc:
                self.logger.exception(
                    "pipeline %s: element %s raised", self.name, node.name)
                self._fail_frame(frame, node.name, repr(exc))
                return FrameOutput(False,
                                   diagnostic=f"{node.name}: {exc!r}")
            ok, outputs = result
            diagnostic = getattr(result, "diagnostic", "")
            if ok and outputs is DEFERRED:
                # park the frame; the element resumes it asynchronously
                frame.deferred_at = index
                frame.deferred_since = element_start
                frame.stream.parked.append(frame)
                return FrameOutput(True, DEFERRED)
            frame.metrics[f"time_{node.name}"] = \
                time.perf_counter() - element_start
            self._record_call_span(node.name, frame, element_start,
                                   frame.metrics[f"time_{node.name}"])
            if not ok:
                diagnostic = diagnostic or "element reported not-ok"
                self._fail_frame(frame, node.name, diagnostic)
                return FrameOutput(
                    False, diagnostic=f"{node.name}: {diagnostic}")
            if outputs:
                self._merge_outputs(node, element_def, outputs, swag)

        frame.metrics["time_pipeline"] = \
            time.perf_counter() - frame.metrics["time_pipeline_start"]
        if self.streams.get(frame.stream.stream_id) is frame.stream:
            # the budget counts whole FRAMES on streams this pipeline
            # owns: a nested element's success mid-frame must not erase
            # the parent stream's run of frame failures
            frame.stream.consecutive_failures = 0
        for handler in self._frame_handlers:
            handler(frame)
        return FrameOutput(True, dict(swag))

    def _merge_outputs(self, node, element_def, outputs, swag) -> None:
        # an element's interface is its declared outputs: scratch values
        # (e.g. a nested pipeline's intermediates) don't leak
        if element_def.output:
            declared = element_def.output_names
            outputs = {k: v for k, v in outputs.items() if k in declared}
        self._scatter_outputs(node.name, outputs, swag)

    def _gather_inputs(self, node_name, element_def, swag):
        """Collect declared inputs from the swag, applying fan-in
        renames."""
        rename = self._renames[node_name]
        inputs = {}
        for input_name in element_def.input_names:
            source_name = input_name if input_name in swag else \
                rename.get(input_name, input_name)
            if input_name in swag:
                inputs[input_name] = swag[input_name]
            elif source_name in swag:
                inputs[input_name] = swag[source_name]
            else:
                return None
        return inputs

    def _scatter_outputs(self, node_name, outputs, swag) -> None:
        """Merge outputs into the swag, applying fan-out renames per edge
        mapping."""
        renamed = dict(outputs)
        for successor in self.graph.successors(node_name):
            mapping = self.graph.mappings.get((node_name, successor), {})
            for src, dst in mapping.items():
                if src in outputs:
                    renamed[dst] = outputs[src]
        swag.update(renamed)

    def _fail_frame(self, frame, node_name, diagnostic) -> None:
        self.logger.error("pipeline %s stream %s frame %s: element %s "
                          "failed: %s", self.name, frame.stream_id,
                          frame.frame_id, node_name, diagnostic)
        self.recovery_stats["frames_failed"] += 1
        stream = frame.stream
        stream.last_diagnostic = f"{node_name}: {diagnostic}"
        if self.streams.get(stream.stream_id) is not stream:
            # nested as an element on the PARENT's stream: the parent
            # charges its own failure budget when our not-ok output
            # propagates — charging here too would double-count every
            # failure, and destroy_stream below could kill an unrelated
            # same-id stream this pipeline happens to own
            return
        stream.consecutive_failures += 1
        if stream.consecutive_failures < self.stream_failure_budget:
            # inside the per-stream failure budget: the frame is lost but
            # the stream survives
            return
        self.recovery_stats["streams_stopped"] += 1
        self.destroy_stream(frame.stream_id)

    def stop(self) -> None:
        for stream_id in list(self.streams):
            self.destroy_stream(stream_id)
        for node in self.graph.nodes():
            node.element.stop()
        super().stop()
