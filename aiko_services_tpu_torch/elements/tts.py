# Neural TTS pipeline element: batched text → speech on the
# ComputeRuntime.
#
# Counterpart of aiko_services_tpu/elements/tts.py: frames from many
# streams coalesce into one device program per batch (the acoustic model,
# then Griffin-Lim or the neural vocoder, models/tts.py synthesize), in
# one bucket of max_tokens byte tokens.  The collated token batch crosses
# to the card in one pinned copy; the host gets back the waveforms and
# each row's voiced sample count, and trims each row to max(count, hop).
# Weights: the port's seeded init (a torch.Generator seeded 0 on the
# ComputeRuntime's device), or a flat npz (`weights`, `vocoder_weights`)
# keyed by the JAX tree paths, as the JAX element's save_flat_npz writes
# them.

from __future__ import annotations

import numpy as np
import torch

from ..compute import resolve_pipelined
from ..pipeline import DEFERRED, Frame, FrameOutput, PipelineElement
from ..utils import get_logger
from .speech import _host_to

__all__ = ["PE_NeuralTTS"]


class PE_NeuralTTS(PipelineElement):
    """text → audio.  Parameters: preset (test/base), weights (flat npz),
    tokenizer (vocab dir or builtin:byte), mode ("batched"|"sync"),
    max_tokens, max_batch, max_wait, gl_iters, vocoder_weights (flat
    npz: the neural vocoder replaces Griffin-Lim), vocoder_preset,
    pipelined, compute.  Emits {"audio": float32[samples],
    "sample_rate"}."""

    contracts = {"in:text": "str", "out:audio": "f32[*]"}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.logger = get_logger(f"tts.{self.name}")
        self._program = f"neural_tts.{self.definition.name}"
        self._setup_done = False
        self.tokenizer = None

    def _setup(self) -> None:
        if self._setup_done:
            return
        from ..bridge import load_flat_npz
        from ..models.tokenizer import ByteTokenizer, load_tokenizer
        from ..models.tts import (TTS_PRESETS, local_heads, synthesize,
                                  tts_axes, tts_init)
        from ..ops.audio import WHISPER_HOP

        preset, _ = self.get_parameter("preset", "test")
        weights, _ = self.get_parameter("weights", "")
        tokenizer_path, _ = self.get_parameter("tokenizer", "builtin:byte")
        max_batch, _ = self.get_parameter("max_batch", 16)
        max_wait, _ = self.get_parameter("max_wait", 0.05)
        gl_iters, _ = self.get_parameter("gl_iters", 32)
        self.mode, _ = self.get_parameter("mode", "batched")

        compute_name, _ = self.get_parameter("compute", "compute")
        self.compute = self.runtime.service_by_name(compute_name)
        if self.compute is None:
            raise RuntimeError(f"TTS element {self.name}: no "
                               f"ComputeRuntime named {compute_name!r}")
        device = self.compute.device
        self.config = config = TTS_PRESETS[str(preset)]
        max_tokens, _ = self.get_parameter("max_tokens", config.max_tokens)
        self.max_tokens = min(int(max_tokens), config.max_tokens)
        # stream-start model load is the sanctioned lazy-init seam
        self.tokenizer = ByteTokenizer() if tokenizer_path == \
            "builtin:byte" else load_tokenizer(str(tokenizer_path))  # graft: disable=lint-blocking-call
        params = tts_init(torch.Generator(device=device).manual_seed(0),
                          config, device=device)
        if weights:
            load_flat_npz(params, str(weights))
        # on a model axis this rank's shards (tts_axes: heads, ffn and
        # the byte embedding's rows; the heads must divide)
        mesh = self.compute.sharding_mesh
        local_heads(config, mesh)
        self.params = self.compute.place_params(params, tts_axes(config))
        gl_iters = int(gl_iters)

        # mel → waveform: the neural vocoder when a checkpoint is given,
        # else weight-free Griffin-Lim
        vocoder_weights, _ = self.get_parameter("vocoder_weights", "")
        vocoder_preset, _ = self.get_parameter("vocoder_preset", "test")
        self.vocoder = self.vocoder_config = None
        if vocoder_weights:
            from ..models.vocoder import (VOCODER_PRESETS, vocoder_axes,
                                          vocoder_init)
            self.vocoder_config = VOCODER_PRESETS[str(vocoder_preset)]
            vocoder = vocoder_init(
                torch.Generator(device=device).manual_seed(0),
                self.vocoder_config, device=device)
            load_flat_npz(vocoder, str(vocoder_weights))
            # vocoder_axes cut nothing under DEFAULT_RULES ("embed" maps
            # to no mesh axis): place_params keeps the module, whole on
            # every rank, as JAX replicates it
            self.vocoder = self.compute.place_params(
                vocoder, vocoder_axes(self.vocoder_config))

        def run_bucket(_bucket, token_batch):
            return synthesize(self.params, config, token_batch,
                              n_iter=gl_iters, vocoder=self.vocoder,
                              vocoder_config=self.vocoder_config, mesh=mesh)

        def collate(bucket, payloads):
            batch = np.zeros((len(payloads), bucket), dtype=np.int32)
            for i, ids in enumerate(payloads):
                t = min(len(ids), bucket)
                batch[i, :t] = np.asarray(ids[:t], dtype=np.int32)
            return _host_to(device, batch)

        def split(results, count):
            # trim each row to its predicted length: the static tail past
            # the regulator's total synthesizes silence-garbage
            audio_batch, samples = results
            audio_batch = audio_batch.cpu().numpy()
            samples = samples.cpu().numpy()
            return [audio_batch[i, :max(int(samples[i]), WHISPER_HOP)]
                    for i in range(count)]

        pipelined, _ = self.get_parameter("pipelined", False)
        pipelined = resolve_pipelined(pipelined, self.mode)
        self.compute.register_batched(
            self._program, run_bucket, [self.max_tokens], collate, split,
            max_batch=int(max_batch), max_wait=float(max_wait),
            pipelined=pipelined)
        self._setup_done = True

    def start_stream(self, stream) -> None:
        self._setup()

    def process_frame(self, frame: Frame, text="", **_) -> FrameOutput:
        self._setup()
        from ..ops.audio import WHISPER_SAMPLE_RATE

        ids = self.tokenizer.encode(str(text))[:self.max_tokens]
        if not ids:
            ids = [32]                                   # space: silence
        if self.mode == "sync":
            box = {}
            self.compute.submit(self._program, frame.stream_id, ids,
                                len(ids),
                                lambda _sid, r: box.setdefault("r", r))
            self.compute.programs[self._program].scheduler.drain(
                force=True)
            result = box["r"]
            if isinstance(result, Exception):
                return FrameOutput(False, diagnostic=repr(result))
            return FrameOutput(True, {"audio": result,
                                      "sample_rate": WHISPER_SAMPLE_RATE})

        def callback(_sid, result):
            outputs = result if isinstance(result, Exception) else \
                {"audio": result, "sample_rate": WHISPER_SAMPLE_RATE}
            self.pipeline.post("resume_frame", frame,
                               self.definition.name, outputs)

        self.compute.submit(self._program, frame.stream_id, ids, len(ids),
                            callback)
        return FrameOutput(True, DEFERRED)
