# Audio I/O and DSP elements.
#
# The port's own copy of aiko_services_tpu/elements/audio.py: microphone
# sources (the deterministic PE_MicrophoneSim used by tests, demos and
# load runs, and the sounddevice PE_Microphone, which imports its audio
# library when a stream starts), the FFT, amplitude / band filtering,
# band resampling, the spectrum raster, the speaker sink, and the binary
# remote tensor path (zlib + npy over the runtime's binary topics).
# PE_FFT runs torch.fft.rfft on the card unless its `device` parameter
# says "cpu"; the others are host code.

from __future__ import annotations

import io
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..pipeline import Frame, FrameOutput, PipelineElement
from ..utils import get_logger
from .speech import _host_to

__all__ = [
    "PE_MicrophoneSim", "PE_Microphone", "PE_Speaker", "PE_FFT",
    "PE_GraphXY", "PE_AudioFilter", "PE_AudioResampler",
    "PE_RemoteSend", "PE_RemoteReceive", "encode_tensor",
    "decode_tensor",
]

SAMPLE_RATE = 16000


# -- binary tensor marshalling ----------------------------------------------

def encode_tensor(array) -> bytes:
    """ndarray → zlib(npy) bytes for binary transport topics."""
    buffer = io.BytesIO()
    np.save(buffer, np.asarray(array), allow_pickle=False)
    return zlib.compress(buffer.getvalue())


def decode_tensor(payload: bytes):
    return np.load(io.BytesIO(zlib.decompress(payload)),
                   allow_pickle=False)


class PE_MicrophoneSim(PipelineElement):
    """Deterministic microphone: emits `chunk_seconds` of synthesized
    audio (tone + noise) per timer tick — the hardware-free source for
    tests, demos and load benchmarks.  `limit` > 0 stops it after that
    many chunks."""

    contracts = {"out:audio": "f32[*]"}

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


class PE_Microphone(PipelineElement):
    """Hardware microphone via sounddevice, imported when a stream
    starts: raises a clear error when no capture stack is present.  The
    capture thread marshals chunks onto the event loop via
    create_frame."""

    def start_stream(self, stream) -> None:
        try:
            import sounddevice
        except ImportError as exc:
            raise RuntimeError(
                "PE_Microphone needs the sounddevice capture stack; use "
                "PE_MicrophoneSim for hardware-free runs") from exc

        rate, _ = self.get_parameter("rate", SAMPLE_RATE, stream)
        chunk_seconds, _ = self.get_parameter("chunk_seconds", 1.0, stream)
        chunks: list = []
        samples = int(float(chunk_seconds) * int(rate))

        def on_audio(indata, _frames, _time, _status):
            chunks.append(indata[:, 0].copy())
            total = sum(c.size for c in chunks)
            if total >= samples:
                audio = np.concatenate(chunks)[:samples].astype("float32")
                chunks.clear()
                self.create_frame(stream, {"audio": audio})

        sd_stream = sounddevice.InputStream(
            samplerate=int(rate), channels=1, callback=on_audio)
        sd_stream.start()
        stream.variables[f"{self.definition.name}.sd"] = sd_stream

    def stop_stream(self, stream) -> None:
        sd_stream = stream.variables.get(f"{self.definition.name}.sd")
        if sd_stream:
            sd_stream.stop()
            sd_stream.close()

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})


class PE_Speaker(PipelineElement):
    """Playback sink — sounddevice when present, else collects into
    stream.variables["speaker.audio"] (the testable sink)."""

    contracts = {"in:audio": "f32[*]"}

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


class PE_FFT(PipelineElement):
    """audio → (frequencies, magnitudes): |rfft(audio)| by torch.fft.rfft
    on the card (parameter `device` "default"; "cpu" runs on the host),
    the magnitudes copied back as f32 numpy, the bin frequencies
    np.fft.rfftfreq at parameter `rate`."""

    contracts = {"in:audio": "f32[*]", "out:frequencies": "f64[*]",
                 "out:magnitudes": "f32[*]"}

    def process_frame(self, frame: Frame, audio=None, **_) -> FrameOutput:
        rate, _ = self.get_parameter("rate", SAMPLE_RATE, frame.stream)
        device, _ = self.get_parameter("device", "default", frame.stream)
        target = torch.device("cpu") if device == "cpu" \
            else resolve_device(None)
        audio = np.asarray(audio, dtype="float32")
        spectrum = torch.fft.rfft(_host_to(target, audio))
        magnitudes = spectrum.abs().cpu().numpy()
        frequencies = np.fft.rfftfreq(audio.size, 1.0 / int(rate))
        return FrameOutput(True, {"frequencies": frequencies,
                                  "magnitudes": magnitudes})


class PE_GraphXY(PipelineElement):
    """Spectrum plot: (frequencies, magnitudes) → image [H, W, 3] uint8,
    headless: the raster lands in the swag (parameter `display=true`
    also opens an OpenCV window when cv2 is importable)."""

    def process_frame(self, frame: Frame, frequencies=None,
                      magnitudes=None, **_) -> FrameOutput:
        width, _ = self.get_parameter("width", 320, frame.stream)
        height, _ = self.get_parameter("height", 160, frame.stream)
        display, _ = self.get_parameter("display", False, frame.stream)
        width, height = int(width), int(height)
        magnitudes = np.asarray(magnitudes, dtype="float32")
        frequencies = np.asarray(frequencies, dtype="float32") \
            if frequencies is not None else \
            np.arange(magnitudes.size, dtype="float32")

        image = np.zeros((height, width, 3), np.uint8)
        if magnitudes.size:
            # bin magnitudes into `width` columns by frequency,
            # log-compress, normalize to the frame max
            top = float(frequencies[-1]) or 1.0
            cut_hz = np.linspace(0.0, top, width + 1)[1:-1]
            # reduceat wants starts < size (a 1-bin input would hand it
            # index 1 of a length-1 array)
            cuts = np.minimum(np.searchsorted(frequencies, cut_hz),
                              magnitudes.size - 1)
            starts = np.concatenate(([0], cuts))
            stops = np.concatenate((cuts, [magnitudes.size]))
            sums = np.add.reduceat(magnitudes, starts)
            counts = stops - starts
            columns = np.where(counts > 0,
                               sums / np.maximum(counts, 1), 0.0)
            columns = np.log1p(columns)
            peak = columns.max()
            if peak > 0:
                bars = (columns / peak * (height - 1)).astype(int)
                for x, bar in enumerate(bars):
                    if bar > 0:
                        image[height - bar:, x] = (64, 200, 64)
        # wire parameters arrive as strings: "false" must stay false
        if str(display).lower() == "true":       # pragma: no cover - UI
            try:
                # headless cv2 builds raise cv2.error from imshow:
                # degrade to the swag raster, never fail the frame
                import cv2
                cv2.imshow(self.name, image[..., ::-1])
                cv2.waitKey(1)
            except Exception:
                pass
        return FrameOutput(True, {"image": image})


class PE_AudioFilter(PipelineElement):
    """Band + amplitude filter over FFT output: zeroes magnitudes outside
    [low_hz, high_hz] and below amplitude_floor."""

    def process_frame(self, frame: Frame, frequencies=None,
                      magnitudes=None, **_) -> FrameOutput:
        low, _ = self.get_parameter("low_hz", 0.0, frame.stream)
        high, _ = self.get_parameter("high_hz", 8000.0, frame.stream)
        floor, _ = self.get_parameter("amplitude_floor", 0.0, frame.stream)
        frequencies = np.asarray(frequencies)
        magnitudes = np.asarray(magnitudes).copy()
        keep = (frequencies >= float(low)) & (frequencies <= float(high))
        magnitudes[~keep] = 0.0
        magnitudes[magnitudes < float(floor)] = 0.0
        return FrameOutput(True, {"frequencies": frequencies,
                                  "magnitudes": magnitudes})


class PE_AudioResampler(PipelineElement):
    """Bin FFT magnitudes into `band_count` bands (their means)."""

    def process_frame(self, frame: Frame, frequencies=None,
                      magnitudes=None, **_) -> FrameOutput:
        band_count, _ = self.get_parameter("band_count", 8, frame.stream)
        magnitudes = np.asarray(magnitudes)
        bands = np.array_split(magnitudes, int(band_count))
        levels = np.array([float(np.mean(band)) for band in bands])
        return FrameOutput(True, {"bands": levels})


class PE_RemoteSend(PipelineElement):
    """Tensor egress over a binary transport topic (zlib + npy)."""

    def process_frame(self, frame: Frame, audio=None, **_) -> FrameOutput:
        topic, found = self.get_parameter("topic", stream=frame.stream)
        if not found:
            return FrameOutput(False, diagnostic="no topic")
        self.runtime.publish(str(topic), encode_tensor(audio))
        return FrameOutput(True, {})


class PE_RemoteReceive(PipelineElement):
    """Tensor ingress: subscribes a binary topic at stream start; each
    arriving tensor becomes a new frame (a source element)."""

    def start_stream(self, stream) -> None:
        topic, found = self.get_parameter("topic", stream=stream)
        if not found:
            raise ValueError(f"{self.name}: no topic parameter")
        logger = get_logger(f"remote_receive.{self.name}")

        def on_message(_topic, payload):
            try:
                tensor = decode_tensor(payload)
            except Exception:
                logger.warning("undecodable tensor on %s", topic)
                return
            self.create_frame(stream, {"audio": tensor})

        stream.variables[f"{self.definition.name}.handler"] = \
            (on_message, str(topic))
        self.runtime.add_message_handler(on_message, str(topic),
                                         binary=True)

    def stop_stream(self, stream) -> None:
        entry = stream.variables.get(f"{self.definition.name}.handler")
        if entry:
            self.runtime.remove_message_handler(entry[0], entry[1])

    def process_frame(self, frame: Frame, **_) -> FrameOutput:
        return FrameOutput(True, {})
