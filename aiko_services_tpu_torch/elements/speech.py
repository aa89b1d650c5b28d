# Speech pipeline elements: framing, log-mel frontend, batched Whisper ASR,
# placeholder TTS, wav file I/O.
#
# Counterpart of aiko_services_tpu/elements/speech.py:
#   * PE_LogMel runs the Whisper mel frontend (ops/audio.py) on the card
#     ("default") or the host ("cpu"); on the card the mel stays there for
#     the encoder;
#   * PE_WhisperASR submits to a ComputeRuntime batched program and defers
#     the frame (pipeline.DEFERRED): frames from many streams coalesce into
#     batches of one padded shape, or it runs synchronously with
#     mode="sync".  It keeps the JAX element's parameters and defaults, its
#     bucket ladder (long-audio buckets round up to the flash kernel's
#     geometry), its three input forms (int16 or mu-law samples with the
#     log-mel frontend fused into the device program, or mel incl. packed
#     i8mel rows) and its hallucination gates.  One batched program per
#     mel-frame bucket runs frontend → encoder → cross-KV → greedy decode
#     on the device.  Its parameters are placed by whisper_axes through
#     the runtime (ComputeRuntime.place_params), as the JAX element's
#     are: on a mesh whose model axis spans ranks each rank holds its
#     heads, its share of the FFN and its chunk of the vocabulary, and
#     the programs run tensor-parallel over the runtime's sharding_mesh
#     (models/whisper.py), their batches cut alike on every rank (the
#     runtime's agreed batch cut), every rank giving the same tokens;
#   * PE_Synthesize is the placeholder voice (a formant-ish sine stack).

from __future__ import annotations

import dataclasses
import wave
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..bridge import load_flat_npz, save_flat_npz          # noqa: F401
from ..compute import resolve_pipelined
from ..ops.audio import (WHISPER_HOP, log_mel_spectrogram, mel_i8_unpack,
                         mulaw_decode, mulaw_encode)
from ..pipeline import DEFERRED, Frame, FrameOutput, PipelineElement
from ..utils import LRUCache, get_logger, parse_bool

__all__ = [
    "PE_AudioFraming", "PE_LogMel", "PE_WhisperASR", "PE_Synthesize",
    "PE_AudioReadFile", "PE_AudioWriteFile", "load_wav", "save_wav",
    "compression_ratio", "collate_audio", "collate_mel",
    "load_flat_npz", "save_flat_npz",
]

SAMPLE_RATE = 16000         # voice rate (reference: audio_io.py:224-228)


def compression_ratio(text: str) -> float:
    """len(utf8)/len(zlib(utf8)): degenerate repetition (the classic
    whisper hallucination mode) compresses far better than speech."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def load_wav(pathname: str):
    """wav → float32 [-1, 1] mono numpy array (stdlib only)."""
    with wave.open(pathname, "rb") as reader:
        frames = reader.readframes(reader.getnframes())
        width = reader.getsampwidth()
        channels = reader.getnchannels()
        rate = reader.getframerate()
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    audio = np.frombuffer(frames, dtype=dtype).astype(np.float32)
    audio /= float(np.iinfo(dtype).max)
    if channels > 1:
        audio = audio.reshape(-1, channels).mean(axis=1)
    return audio, rate


def save_wav(pathname: str, audio, sample_rate: int = SAMPLE_RATE) -> None:
    clipped = np.clip(np.asarray(audio), -1.0, 1.0)
    pcm = (clipped * 32767.0).astype(np.int16)
    with wave.open(pathname, "wb") as writer:
        writer.setnchannels(1)
        writer.setsampwidth(2)
        writer.setframerate(sample_rate)
        writer.writeframes(pcm.tobytes())


def _host_to(device: torch.device, array: np.ndarray) -> torch.Tensor:
    """A host array onto `device` in one copy.  On the card the copy
    leaves a pinned buffer with non_blocking=True, so the host does not
    wait for the work queued on the stream (a copy from pageable memory
    synchronizes it); the caching host allocator keeps the buffer until
    its copy has run.  A read-only array (a wire view) is copied first:
    torch must not wrap memory it may not write."""
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:
        array = array.copy()
    host = torch.from_numpy(array)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def collate_audio(payloads, rows: int, bucket: int, wire: str,
                  device: torch.device) -> torch.Tensor:
    """Audio payloads → one [rows, bucket * hop] batch on `device`:
    int16 PCM (float [-1, 1] quantized), or uint8 mu-law codes with
    silence as code 128 (mu-law zero) when wire == "mulaw"."""
    if wire == "mulaw":
        batch = np.full((rows, bucket * WHISPER_HOP), 128, dtype="uint8")
        for i, audio in enumerate(payloads):
            audio = np.asarray(audio)
            t = min(audio.shape[0], batch.shape[1])
            if audio.dtype == np.uint8:
                batch[i, :t] = audio[:t]        # already codes
            else:
                batch[i, :t] = mulaw_encode(audio[:t])
        return _host_to(device, batch)
    batch = np.zeros((rows, bucket * WHISPER_HOP), dtype="int16")
    for i, audio in enumerate(payloads):
        audio = np.asarray(audio)
        t = min(audio.shape[0], batch.shape[1])
        if audio.dtype == np.int16:
            batch[i, :t] = audio[:t]
        else:          # float [-1, 1] → 16-bit PCM quantization
            batch[i, :t] = np.clip(audio[:t] * 32767.0, -32768,
                                   32767).astype(np.int16)
    return _host_to(device, batch)


def collate_mel(payloads, rows: int, bucket: int, n_mels: int,
                device: torch.device) -> torch.Tensor:
    """Mel payloads → one zero-padded bf16 [rows, bucket, n_mels] batch
    on `device`.  Rows already on the card are padded there; host rows
    (numpy or CPU tensors, float or packed i8mel [T, n_mels + 4]) fill
    one host buffer that crosses in a single copy."""
    on_card = {i: mel for i, mel in enumerate(payloads)
               if isinstance(mel, torch.Tensor) and mel.device.type != "cpu"}
    if len(on_card) == len(payloads):
        batch = torch.zeros((rows, bucket, n_mels), dtype=torch.bfloat16,
                            device=device)
    else:
        host = np.zeros((rows, bucket, n_mels), dtype="float32")
        for i, mel in enumerate(payloads):
            if i in on_card:
                continue
            mel = mel.numpy() if isinstance(mel, torch.Tensor) \
                else np.asarray(mel)
            if mel.dtype == np.int8 and mel.shape[-1] == n_mels + 4:
                mel = mel_i8_unpack(mel)          # packed i8mel rows
            t = min(mel.shape[0], bucket)
            host[i, :t] = mel[:t]
        batch = _host_to(device, host).to(torch.bfloat16)
    for i, mel in on_card.items():
        t = min(mel.shape[0], bucket)
        batch[i, :t] = mel[:t]
    return batch


class PE_AudioFraming(PipelineElement):
    """Sliding-window concat: keeps the last `window_count` audio chunks
    per stream and emits their concatenation — more ASR context per frame
    (reference: speech_elements.py:44-73)."""

    contracts = {"audio": "f32[*]"}

    def start_stream(self, stream) -> None:
        count, _ = self.get_parameter("window_count", 3, stream)
        stream.variables[f"{self.definition.name}.window"] = \
            LRUCache(int(count))

    def process_frame(self, frame: Frame, audio=None, **_) -> FrameOutput:
        window: LRUCache = frame.stream.variables[
            f"{self.definition.name}.window"]
        window.put(frame.frame_id, np.asarray(audio))
        chunks = [window.get(key) for key in sorted(window.keys())]
        return FrameOutput(True, {"audio": np.concatenate(chunks)})


class PE_LogMel(PipelineElement):
    """audio [T_samples] → log-mel [T_frames, 80] f32.

    Parameter `device`: "default" runs on the card (the mel stays there
    for the encoder; raises without a card); "cpu" runs on the host."""

    contracts = {"in:audio": "f32[*]", "out:mel": "f32[*,80]"}

    def process_frame(self, frame: Frame, audio=None, **_) -> FrameOutput:
        device, _ = self.get_parameter("device", "default", frame.stream)
        target = torch.device("cpu") if device == "cpu" \
            else resolve_device(None)
        samples = _host_to(target, np.asarray(audio, dtype="float32")[None])
        return FrameOutput(True, {"mel": log_mel_spectrogram(samples)[0]})


class PE_WhisperASR(PipelineElement):
    """Batched Whisper ASR through a ComputeRuntime.

    Parameters (name: default): preset "tiny", mode "batched" | "sync",
    max_tokens 24, buckets [100, 500, 1000, 3000] (mel frames),
    flash_buckets (default: on unless `weights` is set), max_batch 32,
    max_wait 0.05, deadline_ms 0 (a per-frame completion budget), pad_batch
    (default: mode == "batched"), frontend "mel" | "audio", wire "int16" |
    "mulaw", language "", task "transcribe", timestamps False, kv_quant
    False | "tensor" | "position", logprob_threshold -1.0,
    compression_ratio_threshold 2.4, weights "" (a flat npz), compute
    "compute" (the ComputeRuntime's service name in this process).  The
    model runs in bfloat16.  Emits {"tokens", "text", "avg_logprob"}
    (+ "segments" with timestamps, + "suppressed" when a gate fired)."""

    contracts = {
        # float mel, or pre-packed i8mel rows ([T, 80+4]: int8 codes +
        # per-row f32 scale bytes — the ASR wire codec, ops/audio.py)
        "in:mel": "f32[*,80] | bf16[*,80] | i8mel-i8[*,84]",
        # raw float samples, 16-bit PCM, or pre-encoded µ-law codes
        "in:audio": "f32[*] | i16[*] | mulaw-u8[*]",
        "out:tokens": "i32[*]",
        "out:text": "str",
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.logger = get_logger(f"asr.{self.name}")
        self._program = f"whisper_asr.{self.definition.name}"
        self._setup_done = False
        self.detokenizer = lambda ids: " ".join(str(t) for t in ids)

    # -- model + program setup (lazy: first stream) -------------------------
    def _setup(self) -> None:
        if self._setup_done:
            return
        from ..models.whisper import (
            WHISPER_PRESETS, WhisperConfig, greedy_decode_scored,
            sot_sequence_for, whisper_axes, whisper_init)
        from ..ops.attention import FLASH_MIN_SEQ

        preset, _ = self.get_parameter("preset", "tiny")
        max_tokens, _ = self.get_parameter("max_tokens", 24)
        buckets, _ = self.get_parameter("buckets", [100, 500, 1000, 3000])
        weights, _ = self.get_parameter("weights", "")
        # long-audio buckets round up to flash-kernel geometry: the
        # kernel path needs ctx % 128 == 0 and ctx >= FLASH_MIN_SEQ, e.g.
        # 3000 mel frames (ctx 1500) pad ~2% to 3072 (ctx 1536).  Off by
        # default when a checkpoint is loaded: its trained audio ctx must
        # not be stretched to positions it never saw.
        flash_buckets, _ = self.get_parameter("flash_buckets", not weights)
        if parse_bool(flash_buckets, not weights):
            buckets = sorted({
                b if b // 2 < FLASH_MIN_SEQ else -(-b // 256) * 256
                for b in buckets})
        max_batch, _ = self.get_parameter("max_batch", 32)
        max_wait, _ = self.get_parameter("max_wait", 0.05)
        self.mode, _ = self.get_parameter("mode", "batched")
        self.frontend, _ = self.get_parameter("frontend", "mel")
        max_tokens = int(max_tokens)
        self.buckets = list(buckets)
        # per-frame completion budget: frames submit with an absolute
        # deadline and the batch former dispatches a partial batch
        # early when the earliest deadline is at risk
        deadline_ms, _ = self.get_parameter("deadline_ms", 0)
        self.deadline_s = float(deadline_ms) / 1000.0

        language, _ = self.get_parameter("language", "")
        task, _ = self.get_parameter("task", "transcribe")
        timestamps, _ = self.get_parameter("timestamps", False)
        self.timestamps = parse_bool(timestamps, False)
        logprob_threshold, _ = self.get_parameter(
            "logprob_threshold", -1.0)
        self.logprob_threshold = float(logprob_threshold)
        compression_threshold, _ = self.get_parameter(
            "compression_ratio_threshold", 2.4)
        self.compression_threshold = float(compression_threshold)
        kv_quant, _ = self.get_parameter("kv_quant", False)
        if isinstance(kv_quant, str):
            # wire-delivered parameters arrive as strings; an
            # unrecognized mode fails loudly instead of falling back
            kv_mode = kv_quant.strip().lower()
            if kv_mode in ("tensor", "position"):
                self.kv_quant = kv_mode
            elif kv_mode in ("true", "t", "yes", "on", "1"):
                self.kv_quant = True
            elif kv_mode in ("false", "f", "no", "off", "0", ""):
                self.kv_quant = False
            else:
                raise ValueError(
                    f"ASR element {self.name}: unrecognized kv_quant "
                    f"mode {kv_quant!r} (expected tensor | position | "
                    f"a boolean)")
        else:
            self.kv_quant = parse_bool(kv_quant, False)
        tokenizer_path, _ = self.get_parameter("tokenizer", "")
        if tokenizer_path:
            from ..models.tokenizer import load_tokenizer
            # stream-start model load is the sanctioned lazy-init seam
            self.detokenizer = load_tokenizer(str(tokenizer_path)).decode  # graft: disable=lint-blocking-call
        pp_stages, _ = self.get_parameter("pp_stages", 0)
        pp_stages = int(pp_stages)

        compute_name, _ = self.get_parameter("compute", "compute")
        self.compute = self.runtime.service_by_name(compute_name)
        if self.compute is None:
            raise RuntimeError(
                f"ASR element {self.name}: no ComputeRuntime service "
                f"named {compute_name!r} in this process")
        device = self.compute.device

        base = WHISPER_PRESETS[str(preset)]
        # context sized to the largest bucket (mel frames → ctx = frames/2)
        self.config = WhisperConfig(
            n_mels=base.n_mels, n_audio_ctx=max(buckets) // 2,
            n_text_ctx=max_tokens + 8, n_vocab=base.n_vocab,
            dim=base.dim, num_heads=base.num_heads,
            enc_layers=base.enc_layers, dec_layers=base.dec_layers,
            dtype=torch.bfloat16, sot=base.sot, eot=base.eot)
        generator = torch.Generator(device=device).manual_seed(0)
        params = whisper_init(generator, self.config, device=device)
        if weights:
            load_flat_npz(params, str(weights))
        # this rank's shards on a model axis (the module itself on one
        # device, or where whisper_axes cut nothing on the mesh)
        self.params = self.compute.place_params(
            params, whisper_axes(self.config))
        mesh = self.compute.sharding_mesh

        audio_frontend = self.frontend == "audio"
        # audio wire: "int16" ships lossless PCM; "mulaw" ships uint8
        # mu-law codes (half the bytes) expanded on the device
        wire, _ = self.get_parameter("wire", "int16")
        wire = str(wire)

        sot_sequence = sot_sequence_for(
            self.config, language=str(language) or None,
            task=str(task), timestamps=self.timestamps)
        if len(sot_sequence) + max_tokens > self.config.n_text_ctx:
            raise ValueError(
                f"ASR element {self.name}: conditioning prompt "
                f"({len(sot_sequence)} tokens) + max_tokens "
                f"({max_tokens}) exceeds decoder context "
                f"{self.config.n_text_ctx}")
        decode_kwargs = dict(max_tokens=max_tokens,
                             sot_sequence=sot_sequence,
                             suppress_timestamps=not self.timestamps,
                             kv_quant=self.kv_quant)

        def to_mel(batch, config):
            if not audio_frontend:
                return batch
            # wire codes expand to float on the device: the host does no
            # per-frame feature work at all
            if wire == "mulaw":
                audio = mulaw_decode(batch)
            else:
                audio = batch.float() / 32768.0
            return log_mel_spectrogram(audio, num_mels=config.n_mels)

        # pp_stages >= 2: pipeline parallelism over device groups: the
        # mel + encoder stage on one group, the autoregressive decode
        # stage on another (StagedExecutor), so batch k+1 encodes while
        # batch k decodes.  The compute program's in_flight is the
        # measured overlap.  Each stage holds only its own parameter
        # subtree, shared by every bucket's executor.  The groups come
        # from parallel.devices(): one card is one device, and the two
        # stages on it raise here, as JAX's do on one device.
        executors = {}
        if pp_stages >= 2:
            from ..parallel import devices, stage_device_groups
            stage_devices = devices(device)
            stage_device_groups(stage_devices, 2)
            self._stage_params = (
                {k: self.params[k]
                 for k in ("conv1", "conv2", "enc_blocks", "ln_enc")},
                {k: self.params[k]
                 for k in ("tok_embed", "pos_embed", "dec_blocks",
                           "ln_dec")},
            )

        def staged(config):
            from ..models.whisper import encode, greedy_decode_from_audio
            from ..parallel import StagedExecutor

            @torch.inference_mode()
            def stage_encode(params, payload):
                return encode(params, config,
                              to_mel(payload, config).to(config.dtype),
                              mesh)

            def stage_decode(params, audio):
                return greedy_decode_from_audio(params, config, audio,
                                                mesh=mesh, **decode_kwargs)

            executor = StagedExecutor(
                [(stage_encode, self._stage_params[0]),
                 (stage_decode, self._stage_params[1])],
                devices=stage_devices)

            def run_staged(batch):
                y = executor.submit(batch)
                # occupancy is the compute program's in_flight (split()
                # retires there, not through executor.collect): undo
                # submit's count so the executor's gauge cannot drift
                executor.in_flight -= 1
                return y
            return run_staged

        def run_bucket(bucket, batch):
            config = dataclasses.replace(self.config,
                                         n_audio_ctx=bucket // 2)
            if pp_stages >= 2:
                if bucket not in executors:
                    executors[bucket] = staged(config)
                return executors[bucket](batch)
            return greedy_decode_scored(self.params, config,
                                        to_mel(batch, config).to(
                                            config.dtype),
                                        mesh=mesh, **decode_kwargs)

        # batched mode pads the batch dim to max_batch so each bucket
        # sees exactly one shape; split() slices the real rows back out
        pad_batch, _ = self.get_parameter("pad_batch",
                                          self.mode == "batched")
        pad_batch = parse_bool(pad_batch, self.mode == "batched")

        def collate(bucket, payloads):
            rows = int(max_batch) if pad_batch else len(payloads)
            if audio_frontend:
                return collate_audio(payloads, rows, bucket, wire, device)
            return collate_mel(payloads, rows, bucket, self.config.n_mels,
                               device)

        def split(results, count):
            tokens, lengths, avg_logprob = (x.cpu().numpy()
                                            for x in results)
            return [(tokens[i, :lengths[i]], int(lengths[i]),
                     float(avg_logprob[i])) for i in range(count)]

        pipelined, _ = self.get_parameter("pipelined", False)
        max_in_flight, _ = self.get_parameter("max_in_flight", 4)
        self.compute.register_batched(
            self._program, run_bucket, self.buckets, collate, split,
            max_batch=int(max_batch), max_wait=float(max_wait),
            pipelined=resolve_pipelined(pipelined, self.mode),
            max_in_flight=int(max_in_flight))
        self._setup_done = True

    @property
    def scheduler(self):
        self._setup()
        return self.compute.programs[self._program].scheduler

    def start_stream(self, stream) -> None:
        self._setup()

    def _payload(self, mel, audio):
        if self.frontend == "audio":
            return audio, int(audio.shape[0]) // WHISPER_HOP
        return mel, int(mel.shape[0])

    def submit(self, stream_id: str, callback, mel=None, audio=None) -> None:
        """Queue one frame outside a pipeline walk; callback(stream_id,
        outputs or Exception) fires when the scheduler runs its batch
        (an engine tick after max_wait, or a forced drain)."""
        self._setup()
        payload, length = self._payload(mel, audio)

        def deliver(sid, result):
            callback(sid, result if isinstance(result, Exception)
                     else self._to_outputs(result))
        self.compute.submit(self._program, stream_id, payload, length,
                            deliver)

    def process_frame(self, frame: Frame, mel=None, audio=None,
                      **_) -> FrameOutput:
        self._setup()
        payload, length = self._payload(mel, audio)
        if self.mode == "sync":
            box = {}
            self.compute.submit(self._program, frame.stream_id, payload,
                                length, lambda _sid, r: box.setdefault("r", r))
            self.scheduler.drain(force=True)
            result = box["r"]
            if isinstance(result, Exception):
                return FrameOutput(False, diagnostic=repr(result))
            return FrameOutput(True, self._to_outputs(result))

        def callback(_sid, result):
            # the scheduler drains on the event loop; resume via the
            # mailbox so ordering with other pipeline work is preserved
            self.pipeline.post("resume_frame", frame, self.definition.name,
                               result if isinstance(result, Exception)
                               else self._to_outputs(result))

        deadline = (self.runtime.event.clock.now() + self.deadline_s) \
            if self.deadline_s > 0 else None
        self.compute.submit(self._program, frame.stream_id, payload, length,
                            callback, deadline=deadline)
        return FrameOutput(True, DEFERRED)

    def _to_outputs(self, result):
        tokens, length, avg_logprob = result
        outputs = {"tokens": tokens, "avg_logprob": avg_logprob}
        if self.timestamps:
            from ..models.whisper import parse_timestamp_segments
            segments, text_tokens = parse_timestamp_segments(tokens,
                                                             length)
            text = self.detokenizer([int(t) for t in text_tokens])
            outputs["segments"] = [
                seg | {"text": self.detokenizer(
                    [int(t) for t in seg["tokens"]])}
                for seg in segments]
        else:
            text = self.detokenizer([int(t) for t in tokens[:length]])
        # hallucination gates: improbable decodes (low mean logprob) or
        # degenerate repetition (text that zlib squashes too well) are
        # suppressed rather than emitted
        reason = ""
        if avg_logprob < self.logprob_threshold:
            reason = f"avg_logprob {avg_logprob:.2f} < " \
                     f"{self.logprob_threshold}"
        else:
            ratio = compression_ratio(text)
            if ratio > self.compression_threshold:
                reason = (f"compression_ratio {ratio:.2f} > "
                          f"{self.compression_threshold}")
        if reason:
            # a suppressed decode must not leak its transcript through
            # any output: text, segments, or the raw token ids
            outputs |= {"text": "", "suppressed": reason,
                        "tokens": np.zeros((0,), np.int32)}
            if "segments" in outputs:
                outputs["segments"] = []
        else:
            outputs["text"] = text
        return outputs


class PE_Synthesize(PipelineElement):
    """Placeholder TTS: a formant-ish sine stack per token — keeps the
    text→audio seam exercised end to end until a neural TTS model lands.
    Tones are seeded with the JAX element's hash(word) % 800, so they
    agree with it inside one process; Python randomises string hashes per
    process, so they are not reproducible across processes."""

    contracts = {"in:text": "str", "out:audio": "f32[*]"}

    def process_frame(self, frame: Frame, text="", **_) -> FrameOutput:
        words = str(text).split() or ["_"]
        duration = 0.08
        t = np.arange(int(SAMPLE_RATE * duration)) / SAMPLE_RATE
        chunks = []
        for word in words:
            f0 = 110.0 + (hash(word) % 800)
            tone = (0.5 * np.sin(2 * np.pi * f0 * t) +
                    0.25 * np.sin(2 * np.pi * 2 * f0 * t))
            envelope = np.minimum(1.0, 10 * (1 - np.abs(2 * t /
                                                        duration - 1)))
            chunks.append((tone * envelope).astype(np.float32))
        return FrameOutput(True, {"audio": np.concatenate(chunks)})


class PE_AudioReadFile(PipelineElement):
    """Source: reads a wav file per frame from parameter/swag `pathname`,
    emits float32 audio."""

    def process_frame(self, frame: Frame, pathname=None, **_) -> FrameOutput:
        if pathname is None:
            pathname, found = self.get_parameter("pathname",
                                                 stream=frame.stream)
            if not found:
                return FrameOutput(False, diagnostic="no pathname")
        audio, rate = load_wav(str(pathname))
        return FrameOutput(True, {"audio": audio, "sample_rate": rate})


class PE_AudioWriteFile(PipelineElement):
    """Sink: appends audio chunks to a wav file per stream
    (reference: speech_elements.py PE_AudioWriteFile)."""

    def process_frame(self, frame: Frame, audio=None, **_) -> FrameOutput:
        pathname, found = self.get_parameter("pathname",
                                             stream=frame.stream)
        if not found:
            return FrameOutput(False, diagnostic="no pathname")
        pathname = str(pathname).format(stream_id=frame.stream_id)
        key = f"{self.definition.name}.audio"
        existing = frame.stream.variables.get(key)
        combined = np.asarray(audio) if existing is None else \
            np.concatenate([existing, np.asarray(audio)])
        frame.stream.variables[key] = combined
        save_wav(pathname, combined)
        return FrameOutput(True, {})
