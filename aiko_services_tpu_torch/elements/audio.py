# Audio source and sink elements.
#
# The port's own copy of PE_MicrophoneSim and PE_Speaker from
# aiko_services_tpu/elements/audio.py: the deterministic microphone used
# by tests, demos and load runs, and the playback sink that collects into
# the stream when no sounddevice stack is present.  The hardware
# microphone, FFT, filters and the remote tensor path come with later
# slices.

from __future__ import annotations

import numpy as np

from ..pipeline import Frame, FrameOutput, PipelineElement

__all__ = ["PE_MicrophoneSim", "PE_Speaker"]

SAMPLE_RATE = 16000


class PE_MicrophoneSim(PipelineElement):
    """Deterministic microphone: emits `chunk_seconds` of synthesized
    audio (tone + noise) per timer tick — the hardware-free source for
    tests, demos and load benchmarks.  `limit` > 0 stops it after that
    many chunks."""

    def start_stream(self, stream) -> None:
        chunk_seconds, _ = self.get_parameter("chunk_seconds", 1.0, stream)
        rate, _ = self.get_parameter("rate", SAMPLE_RATE, stream)
        frequency, _ = self.get_parameter("frequency", 440.0, stream)
        limit, _ = self.get_parameter("limit", 0, stream)
        state = {"count": 0, "limit": int(limit)}
        samples = int(float(chunk_seconds) * int(rate))
        rng = np.random.default_rng(0)

        def tick():
            if stream.state != "run" or (state["limit"] and
                                         state["count"] >= state["limit"]):
                self.runtime.event.remove_timer_handler(state["timer"])
                return
            t = (np.arange(samples) +
                 state["count"] * samples) / float(rate)
            audio = (0.5 * np.sin(2 * np.pi * float(frequency) * t) +
                     0.01 * rng.standard_normal(samples)).astype("float32")
            state["count"] += 1
            self.create_frame(stream, {"audio": audio})

        state["timer"] = self.runtime.event.add_timer_handler(
            tick, float(chunk_seconds), immediate=True)
        stream.variables[f"{self.definition.name}.state"] = state

    def stop_stream(self, stream) -> None:
        state = stream.variables.get(f"{self.definition.name}.state")
        if state:
            self.runtime.event.remove_timer_handler(state["timer"])

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})


class PE_Speaker(PipelineElement):
    """Playback sink — sounddevice when present, else collects into
    stream.variables["speaker.audio"] (the testable sink)."""

    def process_frame(self, frame: Frame, audio=None, **_) -> FrameOutput:
        rate, _ = self.get_parameter("rate", SAMPLE_RATE, frame.stream)
        try:
            import sounddevice
        except ImportError:
            sounddevice = None
        if sounddevice is not None:
            # a failure INSIDE the audio stack is a real fault and must
            # surface — only a missing library selects the test sink
            try:
                sounddevice.play(np.asarray(audio), int(rate))
            except Exception as exc:
                return FrameOutput(
                    False, diagnostic=f"audio playback failed: {exc!r}")
            return FrameOutput(True, {})
        key = "speaker.audio"
        existing = frame.stream.variables.get(key)
        audio = np.asarray(audio)
        frame.stream.variables[key] = audio if existing is None else \
            np.concatenate([existing, audio])
        return FrameOutput(True, {})
