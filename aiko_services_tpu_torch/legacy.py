# Legacy stream-element compatibility shim.
#
# The port's own copy of aiko_services_tpu/legacy.py: elements written
# against the 2020-era stream API (StreamElement subclasses with
# stream_start_handler / stream_frame_handler / stream_stop_handler and a
# START / RUN / STOP lifecycle) run unchanged on the port's pipeline
# (pipeline.py) through this adapter; new code subclasses
# PipelineElement directly.

from __future__ import annotations

from .pipeline import Frame, FrameOutput, PipelineElement, Stream

__all__ = ["StreamElement", "StreamElementState"]


class StreamElementState:
    START = "start"
    RUN = "run"
    STOP = "stop"
    COMPLETE = "complete"


class StreamElement(PipelineElement):
    """2020-API adapter: implement the three *_handler methods, each
    returning (ok, swag_update)."""

    def get_state(self, stream: Stream) -> str:
        return stream.variables.get(f"{self.definition.name}.state2020",
                                    StreamElementState.START)

    def _set_state(self, stream: Stream, state: str) -> None:
        stream.variables[f"{self.definition.name}.state2020"] = state

    # -- legacy handler surface (override these) ---------------------------
    def stream_start_handler(self, stream, stream_id):
        return True, {}

    def stream_frame_handler(self, stream, frame_id, swag):
        return True, {}

    def stream_stop_handler(self, stream, stream_id):
        return True, {}

    # -- modern engine mapping ---------------------------------------------
    def start_stream(self, stream: Stream) -> None:
        self._set_state(stream, StreamElementState.START)
        ok, _ = self.stream_start_handler(stream, stream.stream_id)
        if not ok:
            raise RuntimeError(
                f"{self.definition.name}: stream_start_handler failed")
        self._set_state(stream, StreamElementState.RUN)

    def process_frame(self, frame: Frame, **inputs) -> FrameOutput:
        swag = dict(frame.swag)
        swag.update(inputs)
        ok, update = self.stream_frame_handler(frame.stream,
                                               frame.frame_id, swag)
        return FrameOutput(ok, update or {})

    def stop_stream(self, stream: Stream) -> None:
        self._set_state(stream, StreamElementState.STOP)
        self.stream_stop_handler(stream, stream.stream_id)
        self._set_state(stream, StreamElementState.COMPLETE)
