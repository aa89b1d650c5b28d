# Pipeline framework: a dataflow DAG of PipelineElements processing streams
# of frames.
#
# The port's own copy of aiko_services_tpu/pipeline.py:
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
#     pipeline.post("resume_frame", ...);
#   * remote elements: a placeholder swapped for a proxy when discovery
#     (a ServicesCache over the registrar's table) finds a service that
#     matches the element's service_filter.  A remote element with
#     declared outputs is a request/response hop: the frame defers, the
#     serving pipeline (process_frame_remote) walks its own graph and
#     replies with its final swag.  On a binary-capable transport the
#     frame's tensors cross inside the binary wire envelope
#     (transport/wire.py, optional per-key codecs), bursts coalesce into
#     one envelope, and replies elide untouched inputs.  Hop leases,
#     retries with seeded jittered backoff, failover across discovered
#     candidates, end-to-end deadlines on the wire, a reply replay cache
#     for duplicate requests, and an optional admission gate
#     (ops/admission.py) on the serving side.
# Frames carry a "swag" dict whose values may be torch tensors on the
# card: co-located elements hand tensors to each other with no copy; a
# tensor that crosses a remote hop takes one host copy at the wire.
# All timers (hop leases, retry backoff, the admission drain) run on the
# engine clock.  Where both runtimes enabled the peer data plane, a hop's
# envelopes ride a direct channel negotiated through the broker
# (transport/peer.py); the broker stays the fallback.

from __future__ import annotations

import itertools
import json
import random
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .actor import Actor, get_remote_proxy
from .lease import Lease
from .observe import tracing
from .observe.metrics import MirroredStats, default_registry
from .service import ServiceFilter, ServiceProtocol, ServiceTags
from .share import ServicesCache
from .transport import wire
from .utils import Graph, get_logger, jittered_backoff, load_class

__all__ = [
    "PROTOCOL_PIPELINE", "PipelineDefinition", "PipelineElementDefinition",
    "PipelineGraph", "PipelineElement", "Pipeline", "Stream", "Frame",
    "FrameOutput", "DEFERRED", "parse_pipeline_definition",
    "load_pipeline_definition", "definition_to_dict", "PipelineError",
    "lookup_contract",
]

PROTOCOL_PIPELINE = ServiceProtocol("pipeline")
DEFINITION_VERSION = 0
STREAM_LEASE_TIME = 60.0          # reference: pipeline.py:128
DEFAULT_STREAM_ID = "*"


class PipelineError(ValueError):
    pass


def lookup_contract(contracts: dict, name: str, direction: str):
    """The one contract-lookup rule: a direction-prefixed key
    ("in:audio"/"out:audio") beats a plain one ("audio").  Shared by
    PipelineElementDefinition.contract_for and the static checker's
    class-attribute fallback so the two can never drift."""
    return contracts.get(f"{direction}:{name}", contracts.get(name))


# ---------------------------------------------------------------------------
# Definition schema
# ---------------------------------------------------------------------------

@dataclass
class PipelineElementDefinition:
    """One element in a pipeline definition.

    deploy is either local —  {"local": {"module": ..., "class_name": ...}}
    — or remote — {"remote": {"service_filter": {...}}} (reference:
    pipeline.py:156-173).

    contracts maps io names to dtype/shape/codec contract strings (see
    analysis/contracts.py), e.g. {"audio": "f32[*] | mulaw-u8[*]"}.
    Prefix a key "in:"/"out:" when the same name needs different
    contracts per direction; a plain key covers both.  Declared either
    here, per io item ({"name": "audio", "contract": "f32[*]"}), or as
    a class-level `contracts` attribute on the element class — the
    static checker (python -m aiko_services_tpu_torch.analysis) proves
    producer/consumer compatibility per edge before deployment."""
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

    def contract_for(self, name: str, direction: str) -> str | None:
        """Contract string for an io name; direction is "in" or "out"."""
        return lookup_contract(self.contracts, name, direction)


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
    reply_to: tuple | None = None       # (topic, hop_id): remote serving
    reply_skip: dict | None = None      # original remote inputs: values
                                        # still identical at reply time
                                        # are not echoed back
    # trace position + end-to-end deadline: set from the ambient context
    # (remote frames arrive under the caller's context) or minted fresh
    # when the pipeline has a frame_deadline
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
    itself is host-side control code.

    Subclasses may declare a class-level `contracts` dict (io name →
    contract string, "in:"/"out:" prefixes for direction-specific ones)
    that the static checker uses when the pipeline definition doesn't
    declare its own — resolved by import only, never construction."""

    contracts: dict = {}

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


class _RemoteElementPlaceholder:
    """Stands in for a remote element until discovery finds it
    (reference: PipelineElementRemoteAbsent, pipeline.py:340-352).

    Also holds the hop's coalescing state: frames bound for this
    destination buffer here and flush as ONE envelope when the consumer
    is behind (outstanding replies > 0), amortizing per-message wire
    overhead across the burst.

    `candidates` keeps EVERY currently-discovered matching service (in
    discovery order), not just the active one: when the active proxy
    leaves — or a hop times out against it — the pipeline fails over to
    the next candidate instead of erroring frames.  Values are each
    candidate's advertised peer-endpoint tag (None when the service has
    no peer data plane), for Pipeline._negotiate_peer."""

    def __init__(self, definition: PipelineElementDefinition):
        self.definition = definition
        self.proxy = None
        self.topic_path = None
        # topic_path -> peer endpoint tag value | None
        self.candidates: dict[str, str | None] = {}
        # topic_path -> advertised serving role ("prefill" / "decode" /
        # "colocated" / "" when untagged): the registrar record's role
        # tag, consumed by role-aware candidate rotation
        # (Pipeline._rotate_candidate: a service filter loose enough
        # to match several roles must not fail a decode hop over onto
        # a prefill runtime)
        self.roles: dict[str, str] = {}
        self.buffer: list = []          # (entry, one_way) pending sends
        self.outstanding = 0            # request/response hops in flight
        self.flush_scheduled = False

    @property
    def found(self) -> bool:
        return self.proxy is not None


@dataclass
class _PendingHop:
    """One outstanding request/response remote hop.  The single source
    of truth for everything the recovery machinery needs: the frame to
    resume, retry budget spent, whether a request copy is currently in
    flight, and the timers (timeout lease + scheduled resend) that MUST
    be cancelled on every exit path — reply, expiry, failover redirect,
    stream destruction — so dead hops never fire expired handlers."""
    frame: Frame
    node_name: str
    inputs: dict
    lease: Lease | None = None
    attempts: int = 0               # retries consumed
    sent: bool = False              # a request copy is in flight
    sent_to: str | None = None      # candidate the last copy shipped to
    resend_timer: int | None = None
    # the hop's child trace context (trace id + inherited deadline);
    # every attempt's wire copy carries it, retries re-serialize it with
    # the SHRUNK remaining budget
    trace: "tracing.TraceContext | None" = None
    hop_started: float = 0.0        # perf_counter at hop creation
    attempt_started: float = 0.0    # perf_counter at last wire send

    def cancel(self, engine) -> None:
        if self.lease is not None:
            self.lease.cancel()
            self.lease = None
        if self.resend_timer is not None:
            engine.remove_timer_handler(self.resend_timer)
            self.resend_timer = None


_RETIRED_HOP_CAP = 2048     # recently settled hop ids (reply dedup)
_SERVED_HOP_CAP = 1024      # serving-side request dedup + reply replay
_SERVED_REPLY_CACHE_BYTES = 1 << 18   # replies above this aren't cached
_SERVED_REPLY_BUDGET_BYTES = 8 << 20  # aggregate pin across ALL entries
# per-tenant sub-budget: one flooding tenant's replies must
# not evict every other tenant's replay capacity — a TAGGED tenant over
# this pin demotes ITS OWN oldest replies to dedup-only first, before
# the aggregate budget touches anyone else's.  Untagged traffic ("")
# is exempt: it has no neighbours to be fair to, and capping it would
# silently shrink the aggregate semantics for untenanted serving.
_SERVED_REPLY_TENANT_BUDGET_BYTES = 2 << 20


def _payload_nbytes(value) -> int:
    """Tensor/bytes weight of a reply payload (nested containers
    included) — the replay cache must not pin up to _SERVED_HOP_CAP
    full-size image replies in memory."""
    if isinstance(value, np.ndarray):
        return value.nbytes
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, dict):
        return sum(_payload_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_payload_nbytes(v) for v in value)
    return 0


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

class Pipeline(PipelineElement):
    """The pipeline engine.  A Pipeline is-a PipelineElement, so pipelines
    nest (reference: pipeline.py:377-398).

    Frame walk: topological DAG order; each element's declared inputs are
    gathered from the swag (applying fan-in renames), process_frame invoked,
    outputs renamed per fan-out mapping and merged back into the swag, and
    per-element wall time recorded (reference hot loop: pipeline.py:623-715).
    """

    def __init__(self, runtime, definition: PipelineDefinition,
                 name: str | None = None, definition_pathname: str = "",
                 element_classes: dict | None = None,
                 services_cache: ServicesCache | None = None,
                 stream_lease_time: float = STREAM_LEASE_TIME,
                 auto_create_streams: bool = False,
                 remote_timeout: float = 30.0,
                 coalesce_frames: int = 16,
                 remote_wire_codecs: dict | None = None,
                 remote_retries: int = 0,
                 remote_backoff: float = 0.25,
                 remote_backoff_max: float = 4.0,
                 retry_jitter: float = 0.25,
                 retry_seed: int | None = None,
                 stream_failure_budget: int = 1,
                 frame_deadline: float = 0.0,
                 admission=None):
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
        self._remote: dict[str, _RemoteElementPlaceholder] = {}
        self._services_cache = services_cache
        self._frame_handlers: list[Callable] = []
        # outstanding request/response remote hops: hop_id → (frame,
        # node_name, timeout lease)
        self.remote_timeout = remote_timeout
        self._pending_remote: dict[str, _PendingHop] = {}
        self._hop_counter = itertools.count(1)
        # incarnation nonce: hop ids must not collide across pipeline
        # rebuilds that reuse the same reply topic (embedded runtime
        # re-creation, OS pid reuse), or the serving dedup ring would
        # answer a NEW caller's hop 'name.1' with a replay of the OLD
        # incarnation's cached reply
        self._hop_nonce = uuid.uuid4().hex[:8]
        # -- failure recovery ----------------------------------------------
        # remote_retries > 0 turns the recovery machinery ON: hop
        # timeouts retry with exponential backoff + seeded jitter,
        # candidate rotation tries OTHER discovered services, absent
        # placeholders buffer frames until discovery re-resolves, and
        # proxy loss redirects in-flight hops to the replacement.  The
        # default (0) keeps the legacy fail-fast semantics.
        self.remote_retries = max(0, int(remote_retries))
        self.remote_backoff = float(remote_backoff)
        self.remote_backoff_max = float(remote_backoff_max)
        self.retry_jitter = float(retry_jitter)
        # retry_seed=None spreads the jitter for real (a fleet of
        # pipelines must not retry in lockstep); seed it for tests
        self._retry_rng = random.Random(retry_seed)
        # stream_failure_budget consecutive frame failures stop a stream
        # (1 = legacy: first failure destroys it)
        self.stream_failure_budget = max(1, int(stream_failure_budget))
        # frame_deadline > 0 stamps every NEW frame with an end-to-end
        # deadline (engine-clock seconds): remote hops propagate it,
        # retry backoff is clamped to what remains, and an exhausted
        # budget fails the frame fast — charged to the stream failure
        # budget like any other frame failure
        self.frame_deadline = max(0.0, float(frame_deadline))
        # ad-hoc dict preserved for existing readers; increments mirror
        # into the process-wide metrics registry (observe/metrics.py)
        self.recovery_stats = MirroredStats({
            "retries": 0, "failovers": 0, "dup_replies": 0,
            "dup_requests": 0, "replayed_replies": 0,
            "frames_failed": 0, "streams_stopped": 0,
            "one_way_shed": 0, "deadline_exceeded": 0,
            "deadline_rejected": 0, "shed_early": 0,
            "admission_shed": 0,
        }, metric="pipeline_recovery_total",
            help="pipeline recovery machinery events by kind",
            labels={"pipeline": self.name})
        registry = default_registry()
        wire_help = "wire envelopes shipped by the remote-hop data plane"
        self._wire_counters = {
            "request_envelopes": registry.counter(
                "pipeline_wire_envelopes_total", wire_help,
                labels={"pipeline": self.name, "direction": "request"}),
            "request_frames": registry.counter(
                "pipeline_wire_frames_total",
                "frames carried inside wire envelopes",
                labels={"pipeline": self.name, "direction": "request"}),
            "reply_envelopes": registry.counter(
                "pipeline_wire_envelopes_total", wire_help,
                labels={"pipeline": self.name, "direction": "reply"}),
            "reply_frames": registry.counter(
                "pipeline_wire_frames_total",
                "frames carried inside wire envelopes",
                labels={"pipeline": self.name, "direction": "reply"}),
        }
        self._hop_seconds = registry.histogram(
            "pipeline_hop_seconds",
            "remote request/response hop latency (send to reply)",
            labels={"pipeline": self.name})
        self._retired_hops: dict[str, bool] = {}    # reply dedup ring
        self._served_hops: dict = {}    # (reply_topic, hop_id) -> reply
        self._served_reply_bytes = 0    # aggregate pinned reply payload
        self._served_reply_tenant_bytes: dict[str, int] = {}
        # remote-hop wire tuning: coalesce_frames bounds how many frames
        # one envelope may carry (1 disables); codec hints opt named
        # swag keys into lossy wire codecs (transport/wire.py)
        self.coalesce_frames = max(1, int(coalesce_frames))
        self._remote_wire_codecs = dict(remote_wire_codecs or {})
        self._reply_buffer: dict[str, list] = {}
        self._reply_flush_scheduled = False
        # -- overload control ----------------------------------------------
        # admission is an ops/admission.py AdmissionGate: remote
        # requests whose deadline budget cannot survive the estimated
        # queue wait are answered shed-early BEFORE any work, and
        # admitted requests pass a per-tenant weighted fair queue whose
        # inflight window is credited back as replies go out.  None
        # keeps the legacy walk-immediately semantics.
        self.admission = admission
        self._admitted_keys: set = set()
        self._admission_timer = None
        if admission is not None:
            # drain BACKSTOP only: the hot-path trigger is a reply
            # releasing an inflight credit (zero-delay oneshot in
            # _send_remote_reply); this timer exists so a queued frame
            # cannot strand when the pipeline goes idle, so it ticks
            # slowly and exits immediately on an empty queue
            self._admission_timer = runtime.event.add_timer_handler(
                self._drain_admission, 0.05)
            # give the fair queue this runtime's engine clock (unless
            # the gate came with one) so every drained frame observes
            # its MEASURED dwell into admission_queue_wait_seconds —
            # the number request journeys carry
            admission.queue.set_clock(runtime.event.clock.now)
        self._create_elements()
        self._precompute_schedule()
        self.ec_producer.update("element_count", len(self.graph))
        self.ec_producer.update("stream_count", 0)

    # -- element construction (reference: pipeline.py:429-493) --------------
    def _create_elements(self) -> None:
        for node in self.graph.nodes():
            element_def = self.definition.element(node.name)
            if element_def.is_remote:
                placeholder = _RemoteElementPlaceholder(element_def)
                node.element = placeholder
                self._remote[node.name] = placeholder
                self._watch_remote(node.name, element_def)
                continue
            node.element = self._instantiate(element_def)

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
        definitions are computed once, not per frame (the reference rebuilds
        them each frame inside its hot loop, pipeline.py:650-712)."""
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

    @property
    def _recovery_enabled(self) -> bool:
        return self.remote_retries > 0

    @property
    def _peer_host(self):
        """The runtime's peer data plane, when enabled."""
        return getattr(self.runtime, "peer", None)

    def _negotiate_peer(self, topic_path: str) -> None:
        """Open a direct data-plane channel to the service at
        `topic_path` when both sides speak peer: our requests to its
        /in topic and its replies to our topic_in pin to the channel.
        No-op (broker path stays) when either side lacks an endpoint —
        and on refusal/death the PeerHost falls back by itself."""
        host = self._peer_host
        if host is None:
            return
        endpoint = None
        for placeholder in self._remote.values():
            if topic_path in placeholder.candidates:
                endpoint = placeholder.candidates[topic_path]
                break
        if not endpoint:
            return
        try:
            host.negotiate(topic_path, endpoint,
                           pin_topics=[f"{topic_path}/in"],
                           reply_topics=[self.topic_in])
        except Exception:
            # a broken advertisement must not abort _activate_remote —
            # the failover redirect and buffered-frame flush that
            # follow it are correctness, the peer channel is only an
            # optimization
            self.logger.exception(
                "pipeline %s: peer negotiation with %s failed; "
                "staying on the broker path", self.name, topic_path)

    def _watch_remote(self, node_name: str, element_def) -> None:
        """Swap the placeholder for a live proxy when the remote pipeline
        service appears (reference: pipeline.py:591-620).  Every matching
        service is tracked as a candidate; losing the active one fails
        over to the next instead of going absent."""
        if self._services_cache is None:
            return
        raw = element_def.deploy["remote"]["service_filter"]
        service_filter = ServiceFilter(**raw) if isinstance(raw, dict) \
            else raw

        def handler(command, fields):
            placeholder = self._remote[node_name]
            if command == "add":
                # candidates map topic_path → advertised peer endpoint
                # tag (None when the service has no peer data plane);
                # the role tag rides the same record
                tags = ServiceTags.to_dict(fields.tags)
                endpoint = tags.get("peer")
                placeholder.candidates[fields.topic_path] = endpoint
                placeholder.roles[fields.topic_path] = \
                    tags.get("role", "")
                if not placeholder.found:
                    self._activate_remote(node_name, fields.topic_path)
                elif placeholder.topic_path == fields.topic_path:
                    # re-registration of the ACTIVE service (fresh
                    # incarnation, peer enabled late): re-negotiate the
                    # data plane with the current endpoint facts
                    self._negotiate_peer(fields.topic_path)
            elif command == "remove":
                placeholder.candidates.pop(fields.topic_path, None)
                placeholder.roles.pop(fields.topic_path, None)
                if self._peer_host is not None:
                    # the service left: its channel (if any) is a
                    # corpse — unpin so traffic rides the broker to
                    # whatever candidate activation picks next
                    self._peer_host.release(f"{fields.topic_path}/in")
                if placeholder.topic_path == fields.topic_path:
                    placeholder.proxy = None
                    placeholder.topic_path = None
                    if placeholder.candidates:
                        self._activate_remote(
                            node_name, next(iter(placeholder.candidates)),
                            failover=True,
                            redirect=self._recovery_enabled)

        self._services_cache.add_handler(handler, service_filter)

    def _activate_remote(self, node_name: str, topic_path: str,
                         failover: bool = False,
                         redirect: bool = False) -> None:
        """Point a remote node at `topic_path` and, on a failover with
        recovery enabled, redirect in-flight and buffered hops to the new
        proxy (duplicate replies from the old one dedup on hop id)."""
        placeholder = self._remote[node_name]
        placeholder.topic_path = topic_path
        placeholder.proxy = get_remote_proxy(
            self.runtime, f"{topic_path}/in", Pipeline,
            codec_hints=self._remote_wire_codecs)
        # first hop to a discovered proxy negotiates a direct channel
        # through the control plane; data envelopes pin to it, with the
        # broker as the standing fallback
        self._negotiate_peer(topic_path)
        if failover:
            self.recovery_stats["failovers"] += 1
            self.logger.warning(
                "pipeline %s: remote element %s failed over to %s",
                self.name, node_name, topic_path)
        else:
            self.logger.info("pipeline %s: remote element %s found at %s",
                             self.name, node_name, topic_path)
        if redirect:
            for hop_id, pending in list(self._pending_remote.items()):
                if pending.node_name == node_name and pending.sent:
                    self._resend_hop(hop_id)
        if placeholder.buffer:
            self._flush_remote(placeholder)

    def remote_elements_ready(self) -> bool:
        return all(p.found for p in self._remote.values())

    # -- stream lifecycle (reference: pipeline.py:717-749) ------------------
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
                element = node.element
                if isinstance(element, PipelineElement):
                    element.start_stream(stream)
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
        # retire every remote hop the stream still has pending: cancel
        # its timeout lease and any scheduled resend, so a dead hop can
        # never fire an expired handler into a destroyed stream
        for hop_id, pending in list(self._pending_remote.items()):
            if pending.frame.stream is stream:
                self._pending_remote.pop(hop_id, None)
                pending.cancel(self.runtime.event)
                self._retire_hop(hop_id)
                self._purge_buffered_hop(pending.node_name, hop_id)
                if pending.sent:
                    self._hop_settled(pending.node_name)
        # answer remote callers of frames still parked DEFERRED: without
        # a reply the caller's serving-side dedup entry stays "in
        # progress" forever and every retry of the hop id is skipped —
        # the failure reply below is cached, so retries replay it
        parked, stream.parked = stream.parked, []
        for frame in parked:
            if frame.reply_to is not None:
                self._send_remote_reply(
                    frame, False,
                    {"diagnostic": stream.last_diagnostic
                     or "stream destroyed while frame deferred",
                     "stream_stopped": True})
        for node in self._topo_nodes:
            element = node.element
            if isinstance(element, PipelineElement):
                try:
                    element.stop_stream(stream)
                except Exception:
                    self.logger.exception(
                        "pipeline %s: %s.stop_stream(%s) raised", self.name,
                        node.name, stream_id)
        self.ec_producer.update("stream_count", len(self.streams))

    def add_frame_handler(self, handler: Callable) -> None:
        """handler(frame) after every completed frame (tests, sinks,
        benchmark harnesses)."""
        self._frame_handlers.append(handler)

    # -- frame engine (reference hot loop: pipeline.py:623-715) -------------
    def process_frame(self, frame_or_stream_id, swag: dict | None = None,
                      _reply_to: tuple | None = None,
                      _reply_skip: dict | None = None,
                      **_kwargs) -> FrameOutput:
        """Dual interface: called with (Frame, **inputs) when nested as an
        element, or with (stream_id, swag) via the actor mailbox.
        _reply_to (internal, set by process_frame_remote): address the
        final swag back to a remote caller when the walk completes."""
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
                # "*" always auto-creates; named streams only when serving
                # remote frames (auto_create_streams) — leased, so orphaned
                # remote streams expire
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
            # trace context: a remote frame arrives under its caller's
            # activated context (process_frame_remote / the actor
            # dispatch); a locally-sourced frame mints a fresh root —
            # with this pipeline's end-to-end deadline when configured
            context = tracing.current_trace()
            if context is None and (self.frame_deadline > 0
                                    or tracing.tracer.enabled):
                deadline = None
                if self.frame_deadline > 0:
                    deadline = self.runtime.event.clock.now() + \
                        self.frame_deadline
                context = tracing.new_trace(deadline=deadline)
            frame = Frame(stream=stream, frame_id=stream.next_frame_id(),
                          swag=dict(swag or {}), reply_to=_reply_to,
                          reply_skip=_reply_skip, trace=context)
        if stream.lease is not None:
            stream.lease.extend()

        frame.metrics["time_pipeline_start"] = time.perf_counter()
        # the walk runs under the frame's trace context: elements,
        # nested pipelines, remote proxies (envelope headers) and
        # TraceCollector leaves all inherit it ambiently
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
            # lease expiry, shutdown): drop the resume quietly — a remote
            # caller was already answered by destroy_stream
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

            diagnostic = ""
            if isinstance(element, _RemoteElementPlaceholder):
                ok, outputs = self._process_remote(element, frame,
                                                   inputs, node.name)
                if not ok:
                    diagnostic = outputs if isinstance(outputs, str) \
                        else "remote element absent"
                    outputs = None
            else:
                try:
                    result = element.process_frame(frame, **inputs)
                except Exception as exc:
                    self.logger.exception(
                        "pipeline %s: element %s raised", self.name,
                        node.name)
                    self._fail_frame(frame, node.name, repr(exc))
                    return FrameOutput(False,
                                       diagnostic=f"{node.name}: {exc!r}")
                ok, outputs = result
                diagnostic = getattr(result, "diagnostic", "")
            if ok and outputs is DEFERRED:
                # park the frame; the element resumes it asynchronously.
                # The stream remembers it so destroy_stream can answer
                # its remote caller instead of leaving the hop hanging
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
        if frame.reply_to is not None:
            self._send_remote_reply(frame, True, swag)
        return FrameOutput(True, dict(swag))

    def _merge_outputs(self, node, element_def, outputs, swag) -> None:
        # an element's interface is its declared outputs: scratch values
        # (e.g. a nested pipeline's intermediates) don't leak
        if element_def.output:
            declared = element_def.output_names
            outputs = {k: v for k, v in outputs.items() if k in declared}
        self._scatter_outputs(node.name, outputs, swag)

    def _gather_inputs(self, node_name, element_def, swag):
        """Collect declared inputs from the swag, applying fan-in renames
        (reference: pipeline.py:657-675)."""
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
        mapping (reference: pipeline.py:687-703)."""
        renamed = dict(outputs)
        for successor in self.graph.successors(node_name):
            mapping = self.graph.mappings.get((node_name, successor), {})
            for src, dst in mapping.items():
                if src in outputs:
                    renamed[dst] = outputs[src]
        swag.update(renamed)

    def _process_remote(self, placeholder, frame, inputs, node_name):
        """Ship a frame to a discovered remote pipeline.

        Result semantics (this framework's contract — the reference's hop
        is fire-and-forget with result return an acknowledged TODO,
        reference pipeline.py:693-695):

        * remote node declares NO outputs → one-way: publish and continue
          the walk (sink semantics, e.g. remote recorder/speaker);
        * remote node declares outputs → request/response: the frame
          DEFERS here, the serving pipeline walks its own graph and
          replies with its final swag to our topic_in
          (resume_remote_frame), which resumes the walk with the declared
          outputs merged; a lease fails the frame if no reply arrives
          within remote_timeout.

        The serving pipeline should run with auto_create_streams=True so
        frames for upstream-created streams are accepted.  On a
        binary-capable transport, tensor values cross inside the binary
        wire envelope (transport/wire.py) — zero text round-trip, with
        optional per-key codecs (remote_wire_codecs) — and bursts of
        frames bound for the same destination coalesce into one
        envelope.  On text-only transports the legacy S-expression path
        applies: tensors must pass through PE_DataEncode before the
        boundary and PE_DataDecode after it (the device data plane
        bypasses this entirely for co-located elements).

        With recovery enabled (remote_retries > 0) an ABSENT placeholder
        no longer fails the frame: the hop buffers (bounded for one-way
        sinks, lease-governed for request/response) and flushes when
        discovery re-resolves the service."""
        element_def = self._element_defs[node_name]
        if not element_def.output:
            if placeholder.found:
                self._queue_remote(placeholder,
                                   [frame.stream_id, inputs], one_way=True)
            elif self._recovery_enabled:
                self._buffer_entry(placeholder,
                                   [frame.stream_id, inputs], one_way=True)
            else:
                return False, None
            return True, {}
        if not placeholder.found and not self._recovery_enabled:
            return False, None
        # hop trace context: child of the frame's context, inheriting
        # the end-to-end deadline.  A frame whose budget is ALREADY
        # spent fails fast here — no send, no retry, the failure
        # charged to the stream budget like any other frame failure
        hop_trace = frame.trace.child() if frame.trace is not None \
            else None
        now = self.runtime.event.clock.now()
        if hop_trace is not None and hop_trace.expired(now):
            self.recovery_stats["deadline_exceeded"] += 1
            return False, (f"deadline exceeded before remote hop "
                           f"{node_name} (budget spent "
                           f"{-hop_trace.remaining(now):.3f}s ago)")
        hop_id = (f"{self.name}.{self._hop_nonce}"
                  f".{next(self._hop_counter)}")
        # keep the sent inputs: the serving side elides identity
        # passthroughs from its reply (no point echoing the payload),
        # so the resume re-merges them from here when declared
        pending = _PendingHop(frame=frame, node_name=node_name,
                              inputs=inputs, trace=hop_trace,
                              hop_started=time.perf_counter())
        self._pending_remote[hop_id] = pending
        self._arm_hop_lease(pending, hop_id)
        entry = self._hop_entry(pending, hop_id)
        if placeholder.found:
            self._queue_remote(placeholder, entry, one_way=False)
        else:
            # awaiting discovery: the lease bounds the wait
            self._buffer_entry(placeholder, entry, one_way=False)
        return True, DEFERRED

    def _hop_entry(self, pending: _PendingHop, hop_id: str) -> list:
        """The wire entry for one request hop.  The trace context is
        re-serialized per send, so a retry carries the SHRUNK remaining
        budget, not the original one.  The stream's tenant/tier
        parameters ride as a trailing self-tagged field list — the
        serving admission gate charges the hop to the right
        per-tenant budget; both fields are markers, so a tenant tag
        without a trace is unambiguous at the receiver."""
        entry = [pending.frame.stream_id, pending.inputs, self.topic_in,
                 hop_id]
        if pending.trace is not None:
            entry.append(pending.trace.to_fields(
                self.runtime.event.clock.now()))
        parameters = pending.frame.stream.parameters
        tenant = parameters.get("tenant")
        if tenant:
            entry.append(wire.tenant_fields(tenant,
                                            parameters.get("tier", 1)))
        return entry

    def _arm_hop_lease(self, pending: _PendingHop, hop_id: str) -> None:
        if pending.lease is not None:
            pending.lease.cancel()
        timeout = self.remote_timeout
        if pending.trace is not None:
            remaining = pending.trace.remaining(
                self.runtime.event.clock.now())
            if remaining is not None:
                # the timeout lease never outlives the frame's deadline:
                # a hop with 0.3 s of budget left times out (and gets
                # its fail-fast verdict) at 0.3 s, not remote_timeout
                timeout = max(0.01, min(timeout, remaining))
        pending.lease = Lease(
            self.runtime.event, timeout, hop_id,
            lease_expired_handler=self._remote_hop_expired)

    def _purge_buffered_hop(self, node_name: str, hop_id: str) -> None:
        """Drop a retired hop's still-buffered request entry — request
        hops escape the one-way shed cap (they are lease-governed), so
        every pop path of _pending_remote must also purge here or an
        absent placeholder's buffer grows without bound over a long
        outage."""
        placeholder = self._remote.get(node_name)
        if placeholder is None:
            return
        placeholder.buffer = [(e, ow) for e, ow in placeholder.buffer
                              if ow or e[3] != hop_id]

    def _buffer_entry(self, placeholder, entry, one_way: bool) -> None:
        """Park a hop for an absent destination.  One-way (sink) entries
        have no lease watching them, so their OWN share of the buffer is
        bounded: past the cap the oldest one-way entry is shed (request
        hops don't count against it — they are lease-governed)."""
        placeholder.buffer.append((entry, one_way))
        cap = max(4 * self.coalesce_frames, 64)
        if one_way and sum(
                1 for _, ow in placeholder.buffer if ow) > cap:
            for index, (_, buffered_one_way) in \
                    enumerate(placeholder.buffer):
                if buffered_one_way:
                    del placeholder.buffer[index]
                    break
            # shed loss must stay observable: soaks and production both
            # read recovery_stats to account for every frame
            self.recovery_stats["one_way_shed"] += 1
            self.logger.debug(
                "pipeline %s: absent remote sink over buffer cap %d; "
                "oldest one-way frame shed", self.name, cap)

    # -- remote-hop coalescing ----------------------------------------------
    # Per-destination send buffer: an idle link (no outstanding replies)
    # flushes immediately, so a lone frame pays no added latency; while
    # the consumer is behind, frames accumulate and flush as ONE
    # envelope when the buffer fills, a reply arrives (ack-clocked), or
    # the next event-engine turn begins — per-message publish/parse/
    # mailbox overhead amortizes across the burst.  Coalescing requires
    # the binary envelope, so text-only transports keep per-frame sends.

    def _queue_remote(self, placeholder, entry, one_way: bool) -> None:
        if self.coalesce_frames <= 1 or \
                not wire.supports_binary(self.runtime.message):
            self._send_remote([(entry, one_way)], placeholder)
            return
        placeholder.buffer.append((entry, one_way))
        if len(placeholder.buffer) >= self.coalesce_frames:
            self._flush_remote(placeholder)
            return
        if not one_way and placeholder.outstanding == 0:
            self._flush_remote(placeholder)
            return
        if one_way and not placeholder.flush_scheduled:
            # idle link (no coalescing window open): ship this frame
            # now — a lone fire-and-forget frame pays no added latency
            self._send_remote([placeholder.buffer.pop()], placeholder)
            # fall through: open a one-turn window so the REST of a
            # burst coalesces
        if not placeholder.flush_scheduled:
            placeholder.flush_scheduled = True
            self.runtime.event.add_oneshot_handler(
                lambda: self._flush_remote(placeholder), 0.0)

    def _flush_remote(self, placeholder) -> None:
        placeholder.flush_scheduled = False
        if not placeholder.buffer:
            return
        entries, placeholder.buffer = placeholder.buffer, []
        self._send_remote(entries, placeholder)

    def _send_remote(self, entries, placeholder) -> None:
        if not placeholder.found:
            if self._recovery_enabled:
                # discovery raced away mid-buffer: hold the hops for the
                # next candidate (request hops stay lease-governed; a
                # stale request whose hop already retired is dropped)
                for entry, one_way in entries:
                    if one_way or entry[3] in self._pending_remote:
                        self._buffer_entry(placeholder, entry, one_way)
                return
            # legacy fail-fast: fail the hops cleanly (never sent, so
            # outstanding was never incremented)
            for entry, one_way in entries:
                if not one_way:
                    pending = self._pending_remote.pop(entry[3], None)
                    if pending is not None:
                        pending.cancel(self.runtime.event)
                        self._retire_hop(entry[3])
                        self.resume_frame(
                            pending.frame, pending.node_name, RuntimeError(
                                f"remote element {pending.node_name} left "
                                f"before send"))
            return
        one_way = [entry for entry, ow in entries if ow]
        # a request whose hop already settled (reply raced the resend,
        # stream destroyed) must not ship again
        request = [entry for entry, ow in entries
                   if not ow and entry[3] in self._pending_remote]
        if one_way:
            try:
                if len(one_way) == 1:
                    placeholder.proxy.process_frame(*one_way[0])
                else:
                    placeholder.proxy.process_frames(one_way)
            except wire.WireError:
                # the walks of these frames already went on (sink
                # semantics): their remote copies are lost, and counted
                self.logger.exception(
                    "pipeline %s: the wire refused %d one-way frame(s)",
                    self.name, len(one_way))
                self.recovery_stats["one_way_shed"] += len(one_way)
            else:
                self._wire_counters["request_envelopes"].inc()
                self._wire_counters["request_frames"].inc(len(one_way))
        if request:
            sent_at = time.perf_counter()
            for entry in request:
                hop = self._pending_remote[entry[3]]
                hop.sent = True
                hop.sent_to = placeholder.topic_path
                hop.attempt_started = sent_at
            placeholder.outstanding += len(request)
            # a tenant-tagged solo entry must ship in the COALESCED
            # form: as the last positional of a bare RPC its tag is
            # indistinguishable from a header-level tenant marker and
            # the receiving actor's pop_tenant would strip it (a trace
            # in that slot survives — the actor re-injects it as the
            # ambient context, but there is no ambient tenant)
            try:
                if len(request) == 1 and \
                        not wire.is_tenant_fields(request[0][-1]):
                    placeholder.proxy.process_frame_remote(*request[0])
                else:
                    placeholder.proxy.process_frames_remote(request)
            except wire.WireError as exc:
                self._fail_unsendable(request, placeholder, exc)
                return
            self._wire_counters["request_envelopes"].inc()
            self._wire_counters["request_frames"].inc(len(request))

    def _fail_unsendable(self, request, placeholder, exc) -> None:
        """The wire refused a request envelope (a value it cannot carry,
        a codec illegal for its dtype): nothing was published, so each
        of its hops fails now with the WireError.  None waits out its
        lease or retries — a resend would meet the same refusal.  The
        failure resumes through the mailbox, after the walk that sent
        the hop has parked its frame."""
        self.logger.error("pipeline %s: the wire refused %d request "
                          "hop(s): %s", self.name, len(request), exc)
        for entry in request:
            hop_id = entry[3]
            pending = self._pending_remote.pop(hop_id, None)
            if pending is None:
                continue
            pending.cancel(self.runtime.event)
            self._retire_hop(hop_id)
            self._purge_buffered_hop(pending.node_name, hop_id)
            self._record_hop_span(pending, hop_id, "wire-error")
            pending.sent = False
            placeholder.outstanding = max(0, placeholder.outstanding - 1)
            self.post("resume_frame", pending.frame, pending.node_name,
                      exc)

    def _hop_settled(self, node_name) -> None:
        """A reply (or expiry) retired one hop: the link has capacity —
        flush anything the coalescer buffered meanwhile."""
        placeholder = self._remote.get(node_name)
        if placeholder is None:
            return
        placeholder.outstanding = max(0, placeholder.outstanding - 1)
        if placeholder.buffer:
            self._flush_remote(placeholder)

    def _remote_hop_expired(self, hop_id) -> None:
        hop_id = str(hop_id)
        pending = self._pending_remote.get(hop_id)
        if pending is None:
            return
        pending.lease = None            # the oneshot just fired
        if pending.sent:
            pending.sent = False
            self._hop_settled(pending.node_name)
        self._record_attempt_span(pending, hop_id, "timeout")
        budget = None
        if pending.trace is not None:
            budget = pending.trace.remaining(
                self.runtime.event.clock.now())
        if pending.attempts < self.remote_retries:
            # bounded retry: exponential backoff + seeded jitter, and
            # rotate to another discovered candidate first — a timeout
            # against a wedged service recovers via its peer
            delay = jittered_backoff(
                self.remote_backoff, pending.attempts + 1,
                self.remote_backoff_max, self.retry_jitter,
                self._retry_rng)
            if budget is not None and budget <= delay:
                # deadline propagation: the backoff would
                # land past the frame's end-to-end SLO — never schedule
                # a retry past the budget; fail fast instead, charged
                # to the stream failure budget below
                self._fail_hop_deadline(pending, hop_id, budget, delay)
                return
            pending.attempts += 1
            self.recovery_stats["retries"] += 1
            placeholder = self._remote.get(pending.node_name)
            if placeholder is None or pending.sent_to is None \
                    or pending.sent_to == placeholder.topic_path:
                # rotate only while the active candidate is still the
                # one that timed this hop out: a burst of simultaneous
                # expiries must advance ONCE, not once per expired hop
                # (an even burst would land back on the dead candidate)
                self._rotate_candidate(pending.node_name)
            pending.resend_timer = self.runtime.event.add_oneshot_handler(
                lambda: self._resend_hop(hop_id), delay)
            return
        if budget is not None and budget <= 0:
            self._fail_hop_deadline(pending, hop_id, budget, 0.0)
            return
        self._pending_remote.pop(hop_id, None)
        self._retire_hop(hop_id)
        self._purge_buffered_hop(pending.node_name, hop_id)
        self._record_hop_span(pending, hop_id, "timeout")
        detail = f" after {pending.attempts} retries" \
            if pending.attempts else ""
        self.resume_frame(pending.frame, pending.node_name, TimeoutError(
            f"remote element {pending.node_name}: no reply within "
            f"{self.remote_timeout}s{detail}"))

    def _fail_hop_deadline(self, pending: _PendingHop, hop_id: str,
                           budget: float, delay: float) -> None:
        """Retire a hop whose end-to-end deadline budget is exhausted:
        fail the frame fast with a diagnostic instead of retrying past
        the SLO.  The failure flows through resume_frame → _fail_frame,
        so it is charged to the stream failure budget."""
        self._pending_remote.pop(hop_id, None)
        self.recovery_stats["deadline_exceeded"] += 1
        self._retire_hop(hop_id)
        self._purge_buffered_hop(pending.node_name, hop_id)
        self._record_hop_span(pending, hop_id, "deadline")
        if delay > 0:
            detail = (f"remaining budget {max(budget, 0.0):.3f}s < "
                      f"next backoff {delay:.3f}s")
        else:
            detail = f"remaining budget {max(budget, 0.0):.3f}s"
        self.resume_frame(pending.frame, pending.node_name, TimeoutError(
            f"remote element {pending.node_name}: deadline exhausted "
            f"after {pending.attempts} retries ({detail})"))

    # -- hop span recording (tracer-gated) ----------------------------------
    def _record_attempt_span(self, pending: _PendingHop, hop_id: str,
                             outcome: str) -> None:
        """One wire attempt settled (reply, or timeout before retry)."""
        trc = tracing.tracer
        if not trc.enabled or pending.trace is None \
                or not pending.attempt_started:
            return
        now = time.perf_counter()
        trc.record(f"hop_attempt:{pending.node_name}",
                   pending.attempt_started, now - pending.attempt_started,
                   context=pending.trace, cat="hop", proc=self.name,
                   span_id=tracing.new_span_id(),
                   args={"hop_id": hop_id, "attempt": pending.attempts,
                         "outcome": outcome,
                         "sent_to": pending.sent_to or ""})
        pending.attempt_started = 0.0

    def _record_hop_span(self, pending: _PendingHop, hop_id: str,
                         outcome: str) -> None:
        """The whole request/response hop settled (every exit path)."""
        duration = time.perf_counter() - pending.hop_started \
            if pending.hop_started else 0.0
        self._hop_seconds.observe(duration)
        trc = tracing.tracer
        if not trc.enabled or pending.trace is None:
            return
        trc.record(f"hop:{pending.node_name}", pending.hop_started,
                   duration, context=pending.trace, cat="hop",
                   proc=self.name,
                   args={"hop_id": hop_id, "attempts": pending.attempts,
                         "outcome": outcome})

    def _rotate_candidate(self, node_name: str) -> None:
        """Advance a remote node to its next discovered candidate (no-op
        with fewer than two).  Role-aware: when the active
        candidate advertises a role tag and SAME-role alternatives
        exist, rotation stays within them — a filter loose enough to
        match a mixed prefill/decode fleet must not fail a decode hop
        over onto a prefill runtime."""
        placeholder = self._remote.get(node_name)
        if placeholder is None or len(placeholder.candidates) < 2:
            return
        order = list(placeholder.candidates)
        role = placeholder.roles.get(placeholder.topic_path, "")
        same_role = [t for t in order
                     if placeholder.roles.get(t, "") == role]
        if placeholder.topic_path in same_role and len(same_role) > 1:
            order = same_role
        try:
            index = order.index(placeholder.topic_path)
        except ValueError:
            index = -1
        next_topic = order[(index + 1) % len(order)]
        if next_topic != placeholder.topic_path:
            self._activate_remote(node_name, next_topic, failover=True)

    def _resend_hop(self, hop_id: str) -> None:
        """Re-ship a pending hop (retry after timeout, or redirect after
        failover) under a fresh timeout lease, with the SAME hop id so
        duplicate replies dedup instead of double-resuming the frame."""
        hop_id = str(hop_id)
        pending = self._pending_remote.get(hop_id)
        if pending is None:
            return
        pending.resend_timer = None
        if pending.frame.stream.state == "stop":
            self._pending_remote.pop(hop_id, None)
            pending.cancel(self.runtime.event)
            self._retire_hop(hop_id)
            self._purge_buffered_hop(pending.node_name, hop_id)
            return
        placeholder = self._remote.get(pending.node_name)
        if placeholder is None:
            return
        self._arm_hop_lease(pending, hop_id)
        # drop any still-buffered copy of this hop before re-queueing
        self._purge_buffered_hop(pending.node_name, hop_id)
        entry = self._hop_entry(pending, hop_id)
        if pending.sent:
            # the in-flight copy is being superseded; release its slot
            pending.sent = False
            placeholder.outstanding = max(0, placeholder.outstanding - 1)
        if placeholder.found:
            self._send_remote([(entry, False)], placeholder)
        else:
            self._buffer_entry(placeholder, entry, one_way=False)

    def _retire_hop(self, hop_id: str) -> None:
        """Remember a settled hop id so a late duplicate reply is
        recognized as such (bounded ring)."""
        self._retired_hops[str(hop_id)] = True
        while len(self._retired_hops) > _RETIRED_HOP_CAP:
            self._retired_hops.pop(next(iter(self._retired_hops)))

    def resume_remote_frame(self, hop_id, ok, outputs=None, elided=None):
        """Reply entry (invoked over the wire by the serving pipeline).
        `elided` names identity-passthrough outputs the serving side
        did not echo: they are restored from the inputs this hop sent —
        only those, so a genuinely dropped output still fails loudly.

        Duplicate replies (retried requests, failover redirects, chaos
        duplication) dedup here: the first reply pops the pending hop,
        later ones find it retired and are counted, not warned."""
        hop_id = str(hop_id)
        pending = self._pending_remote.pop(hop_id, None)
        if pending is None:
            if hop_id in self._retired_hops:
                self.recovery_stats["dup_replies"] += 1
                self.logger.debug("pipeline %s: duplicate reply for "
                                  "settled hop %s", self.name, hop_id)
            else:
                self.logger.warning("pipeline %s: stale remote reply %r",
                                    self.name, hop_id)
            return
        frame, node_name = pending.frame, pending.node_name
        was_sent = pending.sent
        pending.cancel(self.runtime.event)
        self._purge_buffered_hop(node_name, hop_id)
        self._retire_hop(hop_id)
        if was_sent:
            self._hop_settled(node_name)
        replied_ok = str(ok) in ("true", "True")
        outcome = "ok" if replied_ok else "failed"
        self._record_attempt_span(pending, hop_id, outcome)
        self._record_hop_span(pending, hop_id, outcome)
        if not replied_ok:
            self.resume_frame(frame, node_name, RuntimeError(
                f"remote element {node_name} failed: {outputs!r}"))
            return
        outputs = dict(outputs or {})
        sent_inputs = pending.inputs or {}
        for key in elided or []:
            if key in sent_inputs:
                outputs.setdefault(key, sent_inputs[key])
        self.resume_frame(frame, node_name, outputs)

    def resume_remote_frames(self, entries):
        """Coalesced reply entry: one envelope, many hop replies."""
        for entry in entries or []:
            if isinstance(entry, (list, tuple)) and len(entry) >= 2:
                self.resume_remote_frame(*entry[:4])

    def process_frame_remote(self, stream_id, inputs, reply_topic, hop_id,
                             trace=None, tenant=None):
        """Serving entry: walk a frame for a remote caller and reply with
        the final swag when it completes (including through DEFERRED
        elements).

        At-least-once callers (retries, chaos duplication) may deliver
        the same hop twice: the first request walks, a duplicate while
        the walk is still running is skipped (its reply goes out when
        the walk completes), and a duplicate of a COMPLETED hop replays
        the cached reply — the original may have been lost on the wire.

        `trace` (optional trailing entry field) is the caller's hop
        trace context: the walk runs under it — its spans share the
        caller's trace id — and a request arriving with its deadline
        budget already spent is rejected fast instead of walked (the
        caller has, by definition, stopped waiting).

        `tenant` (optional trailing entry field, wire.tenant_fields) is
        the caller stream's tenant/tier tag.  With an admission gate
        configured the request passes two further verdicts
        before any work: shed-early when the estimated queue wait
        cannot meet the remaining deadline budget (one cheap failure
        reply, and the caller fails over), then the per-tenant weighted
        fair queue.  Both markers are self-tagged, so a tenant tag
        arriving without a trace lands in the `trace` slot and is
        re-sorted here."""
        if tenant is None and wire.is_tenant_fields(trace):
            trace, tenant = None, trace
        tenant_name, tier = wire.parse_tenant(tenant)
        key = (str(reply_topic), str(hop_id))
        if key in self._served_hops:
            self.recovery_stats["dup_requests"] += 1
            cached = self._served_hops[key]
            if cached is not None:
                self._replay_reply(cached)
            return
        now = self.runtime.event.clock.now()
        context = tracing.TraceContext.from_fields(trace, now) \
            if trace is not None else tracing.current_trace()
        self._served_hops[key] = None       # walk in progress
        while len(self._served_hops) > _SERVED_HOP_CAP:
            # evict oldest COMPLETED entry: an in-progress (None) entry
            # dropped here would let a retry re-walk a side-effecting
            # frame and orphan the eventual reply caching
            stale = next((k for k, v in self._served_hops.items()
                          if v is not None), None)
            if stale is None:
                break
            evicted = self._served_hops.pop(stale)
            self._served_reply_bytes -= evicted[3]
            self._credit_tenant_reply_bytes(evicted[4], evicted[3])
        if context is not None and context.expired(now):
            # the failure reply is cached in the dedup ring, so a
            # duplicate of this dead request replays the verdict
            self.recovery_stats["deadline_rejected"] += 1
            if self.admission is not None:
                self.admission.count_rejected(tenant_name, tier,
                                              "expired")
            self._shim_failure_reply(
                key, stream_id,
                f"deadline exceeded before processing (hop {hop_id})")
            return
        if self.admission is not None:
            remaining = context.remaining(now) \
                if context is not None else None
            shed, wait = self.admission.shed_early(remaining)
            if shed:
                # reject at the cheapest point: the dedup-cached reply
                # costs one control message, and the caller's retry
                # machinery rotates to another candidate instead of
                # queueing doomed work here (charged to the caller's
                # stream failure budget like deadline_rejected)
                self.recovery_stats["shed_early"] += 1
                self.admission.count_rejected(tenant_name, tier,
                                              "shed-early")
                self._shim_failure_reply(
                    key, stream_id,
                    f"shed-early: estimated queue wait {wait:.3f}s "
                    f"cannot meet remaining budget {remaining:.3f}s "
                    f"(hop {hop_id})")
                return
            item = (key, str(stream_id), dict(inputs or {}), context,
                    tenant_name, tier)
            self._admitted_keys.add(key)
            self.admission.offer(tenant_name, item,
                                 shed=self._shed_admitted, tier=tier,
                                 dispatch=self._run_admitted)
            return
        self._serve_walk(key, str(stream_id), dict(inputs or {}),
                         context, tenant_name, tier)

    def _serve_walk(self, key, stream_id, inputs, context, tenant,
                    tier, verdict: str = "admitted",
                    queue_wait: float | None = None) -> None:
        """Run one admitted remote request's walk.  The tenant tag is
        stamped into the stream's parameters at creation, so elements
        and nested pipelines see it through get_parameter and further
        hops re-ship it.  The admission verdict and measured
        fair-queue wait are posted as a journey note under the frame's
        trace id BEFORE the walk runs — a ContinuousDecoder reached
        synchronously inside this walk claims them into its
        RequestJourney (engine-clock seconds, bounded
        handoff, no coupling between ops/ and serving/)."""
        if context is not None and context.trace_id:
            from .observe.journey import note_admission
            note_admission(context.trace_id, verdict,
                           queue_wait_s=queue_wait, tenant=tenant,
                           tier=tier)
        if tenant and self.auto_create_streams and \
                stream_id not in self.streams:
            self.create_stream(stream_id,
                               parameters={"tenant": tenant,
                                           "tier": tier})
        try:
            with tracing.activate(context):
                result = self.process_frame(stream_id, inputs,
                                            _reply_to=key,
                                            _reply_skip=inputs)
        except Exception as exc:
            self._shim_failure_reply(key, stream_id, repr(exc))
            raise
        if not result.ok:
            self._shim_failure_reply(key, stream_id, result.diagnostic)

    # -- admission gate plumbing -------------------------------------------
    def _run_admitted(self, item) -> None:
        key, stream_id, inputs, context, tenant, tier = item
        # the fair queue measured this frame's dwell as it drained it
        # (synchronously, just before this dispatch) — ONE measurement
        # feeds both the admission_queue_wait_seconds histogram and
        # the journey note
        queue_wait = self.admission.queue.last_dispatch_wait \
            if self.admission is not None else None
        self._serve_walk(key, stream_id, inputs, context, tenant, tier,
                         verdict="admitted", queue_wait=queue_wait)

    def _shed_admitted(self, item) -> None:
        """Fair-queue shed: the frame never ran — answer its caller so
        the dedup ring doesn't strand retries, and give back nothing
        (it never held an inflight credit)."""
        key, stream_id, _inputs, _context, tenant, _tier = item
        self._admitted_keys.discard(key)
        self.recovery_stats["admission_shed"] += 1
        self._shim_failure_reply(
            key, stream_id,
            f"shed: tenant {tenant or 'default'!r} over admission "
            f"budget")

    def _drain_admission(self) -> None:
        if self.admission is not None and self.admission.queue.depth():
            self.admission.drain(self._run_admitted)

    def _shim_failure_reply(self, key, stream_id, diagnostic) -> None:
        """Answer a remote request whose walk died before any frame
        could carry the reply address (unknown stream with auto-create
        off, start_stream raised): the reply is cached in the dedup
        ring, so the caller's retries replay this failure instead of
        being skipped as duplicates of a hop that will never complete."""
        if self._served_hops.get(key, True) is not None:
            return
        shim = Frame(stream=Stream(stream_id=str(stream_id),
                                   state="stop"),
                     frame_id=-1, reply_to=key)
        self._send_remote_reply(shim, False, {"diagnostic": diagnostic})

    def _cache_served_reply(self, key, kind, topic, data,
                            tenant: str = "") -> None:
        """Pin a completed reply for duplicate replay, under THREE
        bounds: the per-entry size cap, the caller tenant's sub-budget
        (_SERVED_REPLY_TENANT_BUDGET_BYTES — a tagged tenant over it
        demotes its OWN oldest replies first, so a flooder cannot evict
        the polite tenants' replay capacity), and the
        aggregate _SERVED_REPLY_BUDGET_BYTES pin.  Demotion is always
        to 'uncached' — still dedup-recognized as completed, just no
        longer replayable — 1024 entries of just-under-cap image
        replies must not pin a quarter gigabyte."""
        nbytes = _payload_nbytes(data)
        self._served_hops[key] = (kind, topic, data, nbytes, tenant)
        self._served_reply_bytes += nbytes
        if nbytes and tenant:
            self._served_reply_tenant_bytes[tenant] = \
                self._served_reply_tenant_bytes.get(tenant, 0) + nbytes
            while self._served_reply_tenant_bytes.get(tenant, 0) > \
                    _SERVED_REPLY_TENANT_BUDGET_BYTES:
                if not self._demote_oldest_reply(key, tenant=tenant):
                    break
        while self._served_reply_bytes > _SERVED_REPLY_BUDGET_BYTES:
            if not self._demote_oldest_reply(key):
                break

    def _demote_oldest_reply(self, keep_key, tenant: str | None = None) \
            -> bool:
        """Demote the oldest pinned reply (of `tenant`, or of anyone)
        to dedup-only; returns False when nothing is left to demote."""
        stale = next(
            (k for k, v in self._served_hops.items()
             if v is not None and v[3] and k != keep_key
             and (tenant is None or v[4] == tenant)), None)
        if stale is None:
            return False
        _, stale_topic, _, stale_nbytes, stale_tenant = \
            self._served_hops[stale]
        self._served_hops[stale] = \
            ("uncached", stale_topic, None, 0, stale_tenant)
        self._served_reply_bytes -= stale_nbytes
        self._credit_tenant_reply_bytes(stale_tenant, stale_nbytes)
        return True

    def _credit_tenant_reply_bytes(self, tenant: str, nbytes: int) -> None:
        if not tenant or not nbytes:
            return
        remaining = self._served_reply_tenant_bytes.get(tenant, 0) - nbytes
        if remaining > 0:
            self._served_reply_tenant_bytes[tenant] = remaining
        else:
            self._served_reply_tenant_bytes.pop(tenant, None)

    def _replay_reply(self, cached) -> None:
        """Re-send a cached reply for a duplicate of a completed hop."""
        kind, topic, data = cached[0], cached[1], cached[2]
        if kind == "uncached":
            self.logger.warning(
                "pipeline %s: duplicate of a completed hop whose reply "
                "was too large to cache; not replayed", self.name)
            return
        self.recovery_stats["replayed_replies"] += 1
        if kind == "bin":
            self._reply_buffer.setdefault(topic, []).append(data)
            if not self._reply_flush_scheduled:
                self._reply_flush_scheduled = True
                self.runtime.event.add_oneshot_handler(
                    self._flush_replies, 0.0)
        else:
            self.runtime.publish(topic, data)

    def process_frames(self, entries):
        """Coalesced one-way entry: one envelope, many (stream_id,
        inputs) frames — the per-message wire overhead amortizes across
        the burst (chunk coalescing)."""
        for entry in entries or []:
            if isinstance(entry, (list, tuple)) and len(entry) >= 2:
                self.process_frame(entry[0], dict(entry[1] or {}))

    def process_frames_remote(self, entries):
        """Coalesced request/response entry: one envelope, many
        (stream_id, inputs, reply_topic, hop_id[, trace][, tenant])
        frames — each frame's OWN trace context and tenant tag ride its
        entry, so coalescing never mixes trace ids, deadlines, or
        per-tenant budgets."""
        required = len(wire.HOP_ENTRY_FIELDS)
        limit = required + len(wire.HOP_ENTRY_OPTIONAL)
        for entry in entries or []:
            if isinstance(entry, (list, tuple)) and \
                    len(entry) >= required:
                self.process_frame_remote(*entry[:limit])

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
        over_budget = \
            stream.consecutive_failures >= self.stream_failure_budget
        if frame.reply_to is not None:
            self._send_remote_reply(frame, False,
                                    {"diagnostic": str(diagnostic),
                                     "stream_stopped": over_budget})
        if not over_budget:
            # inside the per-stream failure budget: the frame is lost but
            # the stream survives — a transient remote fault must not
            # tear down a long-lived stream and leak its consumers
            return
        self.recovery_stats["streams_stopped"] += 1
        self.destroy_stream(frame.stream_id)

    def _send_remote_reply(self, frame, ok: bool, outputs: dict) -> None:
        topic, hop_id = frame.reply_to
        # the caller stream's tenant tag (stamped into auto-created
        # stream parameters by _serve_walk) keys the reply replay
        # cache's per-tenant sub-budget
        tenant = str(frame.stream.parameters.get("tenant", "") or "")
        trc = tracing.tracer
        if trc.enabled and frame.trace is not None:
            # the serving-side "process" span: walk start → reply out
            # (DEFERRED parking included), child of the caller's hop
            now = time.perf_counter()
            started = frame.metrics.get("time_pipeline_start", now)
            trc.record("process", started, now - started,
                       context=frame.trace, cat="serving",
                       proc=self.name, span_id=tracing.new_span_id(),
                       args={"hop_id": str(hop_id), "ok": bool(ok),
                             "stream": frame.stream_id})
        elided: list = []
        if frame.reply_skip:
            # don't echo untouched binary inputs back over the wire
            # (the whole audio/image payload would ride every reply).
            # Elide ONLY read-only payload types (ndarray/bytes — wire
            # decode hands out read-only views, so the element cannot
            # have mutated them in place); the elided key list crosses
            # in the reply so the caller restores EXACTLY these from
            # its sent inputs and nothing else fails silently.
            elided = [k for k, v in outputs.items()
                      if frame.reply_skip.get(k) is v
                      and isinstance(v, (np.ndarray, bytes))]
            outputs = {k: v for k, v in outputs.items()
                       if k not in elided}
        key = (topic, str(hop_id))
        if self.admission is not None and key in self._admitted_keys:
            # the admitted frame's reply is going out: return its
            # inflight credit and release the next queued frame on a
            # fresh engine turn (never recurse inside a drain)
            self._admitted_keys.discard(key)
            self.admission.release()
            self.runtime.event.add_oneshot_handler(
                self._drain_admission, 0.0)
        if wire.supports_binary(self.runtime.message):
            # binary envelope reply: tensors cross back out-of-band
            # (zero text round-trip); replies to one caller coalesce
            # per engine turn
            payload = {k: v for k, v in outputs.items()
                       if isinstance(v, (str, int, float, bool, bytes,
                                         list, tuple, dict))
                       or wire.contains_binary(v)}
            entry = [hop_id, bool(ok), payload, elided]
            if key in self._served_hops:
                if _payload_nbytes(payload) <= _SERVED_REPLY_CACHE_BYTES:
                    self._cache_served_reply(key, "bin", topic, entry,
                                             tenant=tenant)
                else:
                    # completed, but too heavy to pin for replay: a
                    # duplicate request is still recognized (never
                    # re-walked), it just can't be answered again
                    self._served_hops[key] = \
                        ("uncached", topic, None, 0, tenant)
            self._reply_buffer.setdefault(topic, []).append(entry)
            if not self._reply_flush_scheduled:
                self._reply_flush_scheduled = True
                self.runtime.event.add_oneshot_handler(
                    self._flush_replies, 0.0)
            return
        from .utils import generate
        # text fallback: only wire-expressible values cross back —
        # tensors must be PE_DataEncode'd (to str) by the serving graph
        safe = {k: v for k, v in outputs.items()
                if isinstance(v, (str, int, float, bool))}
        text = generate("resume_remote_frame", [hop_id, ok, safe, elided])
        if key in self._served_hops:
            self._cache_served_reply(key, "text", topic, text,
                                     tenant=tenant)
        self.runtime.publish(topic, text)

    def _flush_replies(self) -> None:
        self._reply_flush_scheduled = False
        buffered, self._reply_buffer = self._reply_buffer, {}
        for topic, entries in buffered.items():
            if len(entries) == 1:
                payload = wire.encode_envelope("resume_remote_frame",
                                               entries[0])
            else:
                payload = wire.encode_envelope("resume_remote_frames",
                                               [entries])
            self._wire_counters["reply_envelopes"].inc()
            self._wire_counters["reply_frames"].inc(len(entries))
            self.runtime.publish(topic, payload)

    def stop(self) -> None:
        if self._admission_timer is not None:
            self.runtime.event.remove_timer_handler(self._admission_timer)
            self._admission_timer = None
        if self.admission is not None:
            # queued-but-never-run frames still owe their callers a
            # reply — shed them through the normal failure path first
            self.admission.queue.shed_all(reason="shutdown")
        for stream_id in list(self.streams):
            self.destroy_stream(stream_id)
        # any hop that survived stream teardown (e.g. nested frames on
        # foreign streams) still holds timers: cancel them all
        for hop_id, pending in list(self._pending_remote.items()):
            pending.cancel(self.runtime.event)
            self._retire_hop(hop_id)
        self._pending_remote.clear()
        for node in self.graph.nodes():
            element = node.element
            if isinstance(element, PipelineElement) and element is not self:
                element.stop()
        super().stop()
