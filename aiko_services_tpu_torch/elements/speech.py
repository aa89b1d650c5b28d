# Batched Whisper ASR on the port's ComputeRuntime.
#
# Counterpart of aiko_services_tpu/elements/speech.py's PE_WhisperASR:
# the same parameters and defaults, the same bucket ladder (long-audio
# buckets round up to the flash kernel's geometry), the same three input
# forms (int16 or mu-law samples with the log-mel frontend fused into the
# device program, or host mel incl. packed i8mel rows), the same split and
# hallucination gates.  One batched program per mel-frame bucket runs
# frontend → encoder → cross-KV → greedy decode on the device.
#
# The PipelineElement base, the process runtime's service lookup and the
# pipeline's deferred-frame resume arrive with the host-plane slice.
# Until then the element takes its parameters as a dict and finds its
# ComputeRuntime in `services` by the `compute` parameter; process_frame
# runs one frame synchronously (mode="sync": scheduler.drain(force=True))
# and submit() queues a frame for the caller's next drain.

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..ops.audio import (WHISPER_HOP, log_mel_spectrogram, mel_i8_unpack,
                         mulaw_decode, mulaw_encode)
from ..utils.sexpr import parse_bool

__all__ = ["PE_WhisperASR", "compression_ratio"]


def compression_ratio(text: str) -> float:
    """len(utf8)/len(zlib(utf8)): degenerate repetition (the classic
    whisper hallucination mode) compresses far better than speech."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


class PE_WhisperASR:
    """Batched Whisper ASR through a ComputeRuntime.

    Parameters (name: default): preset "tiny", mode "batched" | "sync",
    max_tokens 24, buckets [100, 500, 1000, 3000] (mel frames),
    flash_buckets (default: on unless `weights` is set), max_batch 32,
    max_wait 0.05, pad_batch (default: mode == "batched"), frontend
    "mel" | "audio", wire "int16" | "mulaw", language "", task
    "transcribe", timestamps False, kv_quant False | "tensor" |
    "position", logprob_threshold -1.0, compression_ratio_threshold
    2.4, weights "" (a flat npz), compute "compute" (the ComputeRuntime's
    name in `services`).  The model runs in bfloat16.  Results are
    {"tokens", "text", "avg_logprob"} (+ "segments" with timestamps,
    + "suppressed" when a gate fired)."""

    def __init__(self, name: str = "PE_WhisperASR",
                 parameters: dict | None = None,
                 services: dict | None = None):
        self.name = name
        self.parameters = dict(parameters or {})
        self.services = dict(services or {})
        self._program = f"whisper_asr.{name}"
        self._setup_done = False
        self.detokenizer = lambda ids: " ".join(str(t) for t in ids)

    def get_parameter(self, key: str, default=None):
        if key in self.parameters:
            return self.parameters[key], True
        return default, False

    # -- model + program setup (lazy: first frame) --------------------------
    def _setup(self) -> None:
        if self._setup_done:
            return
        from ..bridge import load_flat_npz
        from ..models.whisper import (
            WHISPER_PRESETS, WhisperConfig, greedy_decode_scored,
            sot_sequence_for, whisper_init)
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

        compute_name, _ = self.get_parameter("compute", "compute")
        self.compute = self.services.get(str(compute_name))
        if self.compute is None:
            raise RuntimeError(
                f"ASR element {self.name}: no ComputeRuntime service "
                f"named {compute_name!r}")
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
        self.params = whisper_init(generator, self.config, device=device)
        if weights:
            load_flat_npz(self.params, str(weights))

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

        def run_bucket(bucket, batch):
            config = dataclasses.replace(self.config,
                                         n_audio_ctx=bucket // 2)
            if audio_frontend:
                # wire codes expand to float on the device: the host does
                # no per-frame feature work at all
                if wire == "mulaw":
                    audio = mulaw_decode(batch)
                else:
                    audio = batch.float() / 32768.0
                mel = log_mel_spectrogram(audio, num_mels=config.n_mels)
            else:
                mel = batch
            return greedy_decode_scored(self.params, config,
                                        mel.to(config.dtype),
                                        **decode_kwargs)

        # batched mode pads the batch dim to max_batch so each bucket
        # sees exactly one shape; split() slices the real rows back out
        pad_batch, _ = self.get_parameter("pad_batch",
                                          self.mode == "batched")
        pad_batch = parse_bool(pad_batch, self.mode == "batched")

        def rows(count):
            return int(max_batch) if pad_batch else count

        def collate(bucket, payloads):
            if audio_frontend:
                if wire == "mulaw":
                    # silence encodes to code 128 (mu-law zero), not 0
                    batch = np.full((rows(len(payloads)),
                                     bucket * WHISPER_HOP), 128,
                                    dtype="uint8")
                    for i, audio in enumerate(payloads):
                        audio = np.asarray(audio)
                        t = min(audio.shape[0], batch.shape[1])
                        if audio.dtype == np.uint8:
                            batch[i, :t] = audio[:t]   # already codes
                        else:
                            batch[i, :t] = mulaw_encode(audio[:t])
                    return torch.from_numpy(batch).to(device)
                batch = np.zeros((rows(len(payloads)),
                                  bucket * WHISPER_HOP), dtype="int16")
                for i, audio in enumerate(payloads):
                    audio = np.asarray(audio)
                    t = min(audio.shape[0], batch.shape[1])
                    if audio.dtype == np.int16:
                        batch[i, :t] = audio[:t]
                    else:      # float [-1, 1] → 16-bit PCM quantization
                        batch[i, :t] = np.clip(
                            audio[:t] * 32767.0, -32768, 32767
                        ).astype(np.int16)
                return torch.from_numpy(batch).to(device)
            batch = np.zeros((rows(len(payloads)), bucket,
                              self.config.n_mels), dtype="float32")
            for i, mel in enumerate(payloads):
                mel = np.asarray(mel)
                if mel.dtype == np.int8 and \
                        mel.shape[-1] == self.config.n_mels + 4:
                    mel = mel_i8_unpack(mel)     # packed i8mel rows
                t = min(mel.shape[0], bucket)
                batch[i, :t] = mel[:t]
            return torch.from_numpy(batch).to(device, torch.bfloat16)

        def split(results, count):
            tokens, lengths, avg_logprob = (x.cpu().numpy()
                                            for x in results)
            return [(tokens[i, :lengths[i]], int(lengths[i]),
                     float(avg_logprob[i])) for i in range(count)]

        self.compute.register_batched(
            self._program, run_bucket, self.buckets, collate, split,
            max_batch=int(max_batch), max_wait=float(max_wait))
        self._setup_done = True

    @property
    def scheduler(self):
        self._setup()
        return self.compute.programs[self._program].scheduler

    def _payload(self, mel, audio):
        if self.frontend == "audio":
            return audio, int(np.asarray(audio).shape[0]) // WHISPER_HOP
        return mel, int(np.asarray(mel).shape[0])

    def submit(self, stream_id: str, callback, mel=None, audio=None) -> None:
        """Queue one frame; callback(stream_id, outputs or Exception)
        fires when a drain of the scheduler runs its batch."""
        self._setup()
        payload, length = self._payload(mel, audio)

        def deliver(sid, result):
            callback(sid, result if isinstance(result, Exception)
                     else self._to_outputs(result))
        self.compute.submit(self._program, stream_id, payload, length,
                            deliver)

    def process_frame(self, stream_id: str, mel=None, audio=None) -> dict:
        """Run one frame now (the JAX element's mode="sync" path):
        submit, drain(force=True), return its outputs; a batch failure
        raises."""
        self._setup()
        payload, length = self._payload(mel, audio)
        box = {}
        self.compute.submit(self._program, stream_id, payload, length,
                            lambda _sid, r: box.setdefault("r", r))
        self.scheduler.drain(force=True)
        result = box["r"]
        if isinstance(result, Exception):
            raise result
        return self._to_outputs(result)

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
