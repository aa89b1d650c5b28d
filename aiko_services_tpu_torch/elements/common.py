# Arithmetic / plumbing elements used by tests, examples and benchmarks.
# (reference: aiko_services/pipeline_elements.py:37-175)
#
# The port's own copy of aiko_services_tpu/elements/common.py.
# PE_DataEncode / PE_DataDecode move a tensor over a TEXT transport (one
# that cannot carry the binary wire envelope): base64 of the npy bytes,
# the same string the JAX package writes for equal values.  Each codes
# the one input its definition declares, "data" unless it declares
# another name, and emits it under its one declared output (the JAX
# elements read "data" whatever the definition says, so
# examples/pipeline/pipeline_remote.json, which declares "number",
# fails its first frame there: ROADMAP Queue 3 item 17).

from __future__ import annotations

import base64
import io

from ..pipeline import Frame, FrameOutput, PipelineElement, Stream

__all__ = [
    "PE_GenerateNumbers", "PE_Metrics", "PE_Identity",
    "PE_0", "PE_1", "PE_2", "PE_3", "PE_4",
    "PE_DataEncode", "PE_DataDecode",
]


class PE_GenerateNumbers(PipelineElement):
    """Source: emits `number` frames on a timer while the stream runs
    (reference: pipeline_elements.py:37-61 — a thread there; a timer on the
    event engine here, so it is deterministic under a VirtualClock)."""

    def start_stream(self, stream: Stream) -> None:
        rate, _ = self.get_parameter("rate", 10.0, stream)
        limit, _ = self.get_parameter("limit", 0, stream)
        state = {"count": 0, "limit": int(limit)}
        stream.variables[f"{self.definition.name}.state"] = state

        def tick():
            if stream.state != "run":
                self.runtime.event.remove_timer_handler(state["timer"])
                return
            if state["limit"] and state["count"] >= state["limit"]:
                self.runtime.event.remove_timer_handler(state["timer"])
                return
            self.create_frame(stream, {"number": state["count"]})
            state["count"] += 1

        state["timer"] = self.runtime.event.add_timer_handler(
            tick, 1.0 / float(rate), immediate=True)

    def stop_stream(self, stream: Stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state and "timer" in state:
            self.runtime.event.remove_timer_handler(state["timer"])

    def process_frame(self, frame: Frame, **inputs) -> FrameOutput:
        # source: the frame already carries `number` (posted by create_frame)
        return FrameOutput(True, {})


class PE_Metrics(PipelineElement):
    """Sink: publishes per-element frame timings into its EC share
    (reference logs them, pipeline_elements.py:63-79; sharing makes them
    dashboard-visible and machine-readable)."""

    def process_frame(self, frame: Frame, **inputs) -> FrameOutput:
        for name, seconds in frame.metrics.items():
            if name.startswith("time_"):
                self.ec_producer.update(
                    f"metrics.{name}", round(seconds * 1000.0, 3))
        self.ec_producer.update("metrics.frame_id", frame.frame_id)
        return FrameOutput(True, {})


class PE_Identity(PipelineElement):
    """Pass-through: returns declared inputs unchanged (aloha_honua-style
    single-element benchmark pipeline)."""

    def process_frame(self, frame: Frame, **inputs) -> FrameOutput:
        return FrameOutput(True, dict(inputs))


class PE_0(PipelineElement):
    """number → a = number + constant (reference: pipeline_elements.py:82)"""

    def process_frame(self, frame: Frame, number=0, **_) -> FrameOutput:
        constant, _found = self.get_parameter("constant", 1, frame.stream)
        return FrameOutput(True, {"a": number + int(constant)})


class PE_1(PipelineElement):
    def process_frame(self, frame: Frame, number=0, **_) -> FrameOutput:
        return FrameOutput(True, {"a": number + 1})


class PE_2(PipelineElement):
    def process_frame(self, frame: Frame, a=0, **_) -> FrameOutput:
        return FrameOutput(True, {"b": a * 2})


class PE_3(PipelineElement):
    def process_frame(self, frame: Frame, a=0, **_) -> FrameOutput:
        return FrameOutput(True, {"c": a + 10})


class PE_4(PipelineElement):
    """Fan-in: b + c → d"""

    def process_frame(self, frame: Frame, b=0, c=0, **_) -> FrameOutput:
        return FrameOutput(True, {"d": b + c})


def _coded_names(element) -> tuple[str, str]:
    """(input, output) a codec element reads and writes: its one
    declared input and output, "data" where it declares none or several
    (or has no definition: an element called outside a pipeline)."""
    definition = getattr(element, "definition", None)
    inputs = definition.input_names if definition is not None else []
    outputs = definition.output_names if definition is not None else []
    source = inputs[0] if len(inputs) == 1 else "data"
    return source, outputs[0] if len(outputs) == 1 else source


class PE_DataEncode(PipelineElement):
    """Tensor egress: ndarray / torch tensor → base64(npy) string for
    transport over the control plane (reference:
    pipeline_elements.py:147-160).  A tensor on the card takes one host
    copy here; a dtype numpy cannot save (bfloat16) fails the frame."""

    def process_frame(self, frame: Frame, data=None, **inputs) -> FrameOutput:
        import numpy as np
        import torch
        source, target = _coded_names(self)
        if source != "data":
            data = inputs.get(source)
        array = data.detach().cpu().numpy() \
            if isinstance(data, torch.Tensor) else np.asarray(data)
        buffer = io.BytesIO()
        np.save(buffer, array, allow_pickle=False)
        encoded = base64.b64encode(buffer.getvalue()).decode("ascii")
        return FrameOutput(True, {target: encoded})


class PE_DataDecode(PipelineElement):
    """Tensor ingress: base64(npy) string → ndarray
    (reference: pipeline_elements.py:162-175)."""

    def process_frame(self, frame: Frame, data=None, **inputs) -> FrameOutput:
        import numpy as np
        source, target = _coded_names(self)
        if source != "data":
            data = inputs.get(source)
        if isinstance(data, str):
            buffer = io.BytesIO(base64.b64decode(data.encode("ascii")))
            data = np.load(buffer, allow_pickle=False)
        return FrameOutput(True, {target: data})
