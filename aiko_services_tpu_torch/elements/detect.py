# Detection and agent elements.
#
# Counterpart of aiko_services_tpu/elements/detect.py:
#   * PE_Detect, the detect stage of video → detect → tracker (BASELINE.md
#     config 4): frames batch through a ComputeRuntime program, padded to
#     max_batch (one shape per bucket); the uint8 batch (or the int8 dct8
#     codes) crosses to the card once, from a pinned buffer, and the
#     program normalises, runs the detector and decodes its peaks there;
#     split() strips zero-score rows on the host.  pipelined=True moves the
#     wait for the device onto the ComputeRuntime's results worker.
#   * PE_LlamaAgent (and its _session_key): a pipeline element that
#     prompts a decoder-only Llama with a frame's `text` and emits
#     {"response", "response_tokens"}.  In "continuous" mode it serves
#     through the paged ContinuousDecoder pumped from the pipeline's event
#     engine, with the prefix cache and the session table for multi-turn
#     conversations; "batched" and "sync" run llama_greedy_decode through
#     a ComputeRuntime batched program.
# PE_Tracker is in elements/video.py, as in JAX.

from __future__ import annotations

import time

import numpy as np
import torch

from ..compute import resolve_pipelined
from ..pipeline import DEFERRED, Frame, FrameOutput, PipelineElement
from ..utils import parse_bool
from .image import resize_image
from .speech import _host_to

__all__ = ["PE_Detect", "PE_LlamaAgent"]

def _session_key(raw: str) -> str:
    """SessionTable keys may not contain '.', '/', or spaces; stream /
    frame ids may (stream ids embed topic-ish paths).  Deterministic
    sanitization keeps the same stream mapping to the same session."""
    return raw.replace(".", "-").replace("/", "-").replace(" ", "-")


class PE_Detect(PipelineElement):
    """Batched object detection through the ComputeRuntime.  Emits
    {"boxes": [[x1, y1, x2, y2], ...], "scores", "classes"} with
    zero-score detections stripped host-side.

    Parameters (name: default): preset "detector_r18" (detector_r18 /
    detector_test), image_size 256, mode "batched" | "sync",
    score_threshold 0.3, max_batch 16, max_wait 0.05, compute "compute",
    wire "raw" (uint8 frames) | "dct8" (int8 DCT codes, decoded on the
    device), dct_keep 16, dtype "float32" | "bfloat16" (the convolutions;
    the decode is f32 either way), pad_batch (default: mode ==
    "batched"), pipelined false, max_in_flight 4.  Weights are random,
    drawn from a torch.Generator seeded 0 on the ComputeRuntime's
    device."""

    # any-size RGB frame (resized host-side to image_size); uint8 is the
    # wire-native form, floats keep the 0-255 contract.  Detections are
    # host-side python lists
    contracts = {
        "in:image": "u8[*,*,3] | dct8-u8[*,*,3] | f32[*,*,3]",
        "out:boxes": "any", "out:scores": "any", "out:classes": "any",
    }

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._program = f"detect.{self.definition.name}"
        self._setup_done = False

    def _setup(self) -> None:
        if self._setup_done:
            return
        import dataclasses

        from ..models.detector import (DETECTOR_PRESETS, detect,
                                       detector_axes, detector_init)
        from ..ops.image_wire import dct8_decode, dct8_encode

        preset, _ = self.get_parameter("preset", "detector_r18")
        image_size, _ = self.get_parameter("image_size", 256)
        threshold, _ = self.get_parameter("score_threshold", 0.3)
        max_batch, _ = self.get_parameter("max_batch", 16)
        max_wait, _ = self.get_parameter("max_wait", 0.05)
        self.mode, _ = self.get_parameter("mode", "batched")
        self.image_size = size = int(image_size)

        compute_name, _ = self.get_parameter("compute", "compute")
        self.compute = self.runtime.service_by_name(compute_name)
        if self.compute is None:
            raise RuntimeError(f"detect element {self.name}: no "
                               f"ComputeRuntime named {compute_name!r}")
        device = self.compute.device
        config = DETECTOR_PRESETS[str(preset)]
        dtype_name, _ = self.get_parameter("dtype", "float32")
        if str(dtype_name) == "bfloat16":
            config = dataclasses.replace(
                config, dtype=torch.bfloat16,
                backbone=dataclasses.replace(config.backbone,
                                             dtype=torch.bfloat16))
        self.config = config
        params = detector_init(torch.Generator(device=device).manual_seed(0),
                               config, device=device)
        # detector_axes cut nothing under DEFAULT_RULES ("channels" maps
        # to no mesh axis): place_params keeps the module, whole on every
        # rank of a mesh, as JAX replicates the detector
        self.params = self.compute.place_params(params,
                                                detector_axes(params))
        threshold = float(threshold)

        # wire format: "raw" ships uint8 (normalised on the device, a
        # quarter of f32's bytes); "dct8" ships int8 DCT coefficients
        # (another 4x under raw at keep=16) that the program decodes
        wire, _ = self.get_parameter("wire", "raw")
        self.wire = wire = str(wire)
        dct_keep, _ = self.get_parameter("dct_keep", 16)
        dct_keep = int(dct_keep)

        @torch.no_grad()
        def run_bucket(_bucket, batch):
            if wire == "dct8":
                images = dct8_decode(batch, size, size)
            else:
                images = batch.float() / 255.0
            return detect(self.params, config, images,
                          score_threshold=threshold)

        def to_uint8(p):
            # float frames keep the 0-255 contract
            p = np.asarray(p)
            if p.dtype == np.uint8:
                return p
            return np.clip(p, 0, 255).astype(np.uint8)

        # pad partial batches to max_batch: one shape per bucket; split()
        # only reads the real rows back
        pad_batch, _ = self.get_parameter("pad_batch",
                                          self.mode == "batched")
        pad_batch = parse_bool(pad_batch, self.mode == "batched")
        full = int(max_batch)

        def collate(_bucket, payloads):
            rows = full if pad_batch else len(payloads)
            if wire == "dct8":
                batch = np.zeros((rows, size // 8, size // 8, 3, dct_keep),
                                 np.int8)
                for i, p in enumerate(payloads):
                    batch[i] = dct8_encode(to_uint8(p), keep=dct_keep)
            else:
                batch = np.zeros((rows, size, size, 3), np.uint8)
                for i, p in enumerate(payloads):
                    batch[i] = to_uint8(p)
            return _host_to(device, batch)

        def split(results, count):
            boxes, scores, classes = (r.cpu().numpy() for r in results)
            out = []
            for i in range(count):
                keep = scores[i] > 0.0
                out.append({"boxes": boxes[i][keep].tolist(),
                            "scores": scores[i][keep].tolist(),
                            "classes": classes[i][keep].tolist()})
            return out

        pipelined, _ = self.get_parameter("pipelined", False)
        max_in_flight, _ = self.get_parameter("max_in_flight", 4)
        self.compute.register_batched(
            self._program, run_bucket, [self.image_size], collate, split,
            max_batch=int(max_batch), max_wait=float(max_wait),
            pipelined=resolve_pipelined(pipelined, self.mode),
            max_in_flight=int(max_in_flight))
        self._setup_done = True

    def start_stream(self, stream) -> None:
        self._setup()

    def process_frame(self, frame: Frame, image=None, **_) -> FrameOutput:
        self._setup()
        image = np.asarray(image)
        if image.shape[:2] != (self.image_size, self.image_size):
            image = resize_image(image, self.image_size, self.image_size)

        if self.mode == "sync":
            box = {}
            self.compute.submit(self._program, frame.stream_id, image,
                                self.image_size,
                                lambda _sid, r: box.setdefault("r", r))
            self.compute.programs[self._program].scheduler.drain(
                force=True)
            result = box["r"]
            if isinstance(result, Exception):
                return FrameOutput(False, diagnostic=repr(result))
            return FrameOutput(True, result)

        def callback(_sid, result):
            self.pipeline.post("resume_frame", frame,
                               self.definition.name, result)

        self.compute.submit(self._program, frame.stream_id, image,
                            self.image_size, callback)
        return FrameOutput(True, DEFERRED)


class PE_LlamaAgent(PipelineElement):
    """LLM agent stage: takes `text`, prompts the decoder-only model,
    emits {"response", "response_tokens"}.

    Parameters (name: default): preset "tiny" (models/llama.py
    LLAMA_PRESETS, served in the preset's dtype), mode "batched" |
    "sync" | "continuous", max_tokens 16, prompt_length 128, max_batch
    8, max_wait 0.05, compute "compute" (the ComputeRuntime's service
    name in this process), tokenizer "" (a tokenizer directory;
    default: the byte fallback).  Continuous mode: steps_per_sync 4,
    eos_token -1, prefix_block 0 (> 0 binds a prefix cache of that block
    size and forces chunked prefill at prefill_chunk, default
    prompt_length), prefix_cache_mb 64, prefix_tenant_mb 0, paged false,
    sessions false, session_lease 300, session_shards 2, session_idle
    0, session_mirror "", and per stream tenant and session.

    paged false, the default, serves through the dense slot cache (a
    prefix hit copies the cached rows in), paged true through the block
    pool and the paged kernel (a hit aliases the cached blocks).
    host_kv_mb > 0 backs the prefix cache with a host KV tier of that
    many MiB (host_kv_tenant_mb: a per-tenant cap): session demotion and
    LRU pressure demote chain blocks to pinned host memory, and a
    revived session's chain is prefetched back at its turn.  role
    (default "") tags the owning pipeline's discovery record role=<role>;
    disagg true (with a prefix cache or paged true) routes prompts
    through a PrefillClient to a discovered role=prefill runtime, with
    disagg_timeout 5.0 and disagg_retries 1, falling back to local
    prefill, counted.  Weights are random, drawn from a torch.Generator
    seeded 0 on the ComputeRuntime's device.  On a ComputeRuntime mesh
    the element serves this rank's shards in every mode, rank 0
    deciding every timed matter: the batched mode's cut is agreed by
    the runtime (compute.py), so every rank runs the same batches;
    sessions (their lease expiries and idle demotions), host_kv_mb and
    disagg (rank 0's client alone sends a prompt, and every rank
    installs its KV heads of the shipped blocks in the round rank 0's
    landing rides) ride the decoder's round note."""

    contracts = {"in:text": "str", "out:response": "str",
                 "out:response_tokens": "i32[*]"}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._setup_done = False
        self._stats_timer = None
        self._open_streams = 0
        self.prefix_cache = None
        self._session_table = None
        self._session_view = None
        self._prefill_client = None
        self.tokenizer = lambda text: [b % 250 for b in
                                       text.encode("utf-8")][:120]
        self.detokenizer = lambda tokens: " ".join(str(t) for t in tokens)

    def _publish_serving_stats(self) -> None:
        """Decoder occupancy and throughput into the pipeline's EC
        share, deduplicated: an idle decoder streams nothing."""
        producer = getattr(self.pipeline, "ec_producer", None)
        if producer is None:
            return
        name = self.definition.name
        stats = self.decoder.stats
        for key, value in (
                (f"serving.{name}.active", self.decoder.active_count),
                (f"serving.{name}.completed", stats["completed"]),
                (f"serving.{name}.steps", stats["steps"]),
                (f"serving.{name}.occupancy",
                 round(self.decoder.mean_occupancy(), 3))):
            if producer.get(key) != value:
                producer.update(key, value)

    def _setup(self) -> None:
        if self._setup_done:
            return
        from ..models.llama import (LLAMA_PRESETS, llama_axes,
                                    llama_greedy_decode, llama_init)

        preset, _ = self.get_parameter("preset", "tiny")
        max_tokens, _ = self.get_parameter("max_tokens", 16)
        self.prompt_length, _ = self.get_parameter("prompt_length", 128)
        max_batch, _ = self.get_parameter("max_batch", 8)
        max_wait, _ = self.get_parameter("max_wait", 0.05)
        self.mode, _ = self.get_parameter("mode", "batched")
        self._program = f"agent.{self.definition.name}"

        compute_name, _ = self.get_parameter("compute", "compute")
        self.compute = self.runtime.service_by_name(compute_name)
        if self.compute is None:
            raise RuntimeError(f"agent element {self.name}: no "
                               f"ComputeRuntime named {compute_name!r}")
        device = self.compute.device
        config = LLAMA_PRESETS[str(preset)]
        tokenizer_path, _ = self.get_parameter("tokenizer", "")
        if tokenizer_path:
            from ..models.tokenizer import load_tokenizer
            # stream-start model load is the sanctioned lazy-init seam
            bpe = load_tokenizer(str(tokenizer_path))  # graft: disable=lint-blocking-call
            limit = int(self.prompt_length)
            vocab = config.vocab
            # drop ids the model's embedding cannot represent
            self.tokenizer = lambda text: [
                t for t in bpe.encode(text) if t < vocab][:limit]
            self.detokenizer = bpe.decode
        params = llama_init(torch.Generator(device=device).manual_seed(0),
                            config, device=device)
        # placed by the model's logical axes, as JAX's element places
        # them: on a mesh of more than one rank this rank's shards, served
        # with the rank-local config and the mesh's collectives
        self.params = self.compute.place_params(params, llama_axes(config))
        mesh = self.compute.sharding_mesh
        if mesh is not None:
            from ..parallel.sharding import local_config
            rank_config = local_config(config, mesh)
        else:
            rank_config = config
        tokens = int(max_tokens)
        self.max_tokens = tokens
        if self.mode == "continuous":
            self._setup_continuous(config, int(max_batch), mesh)
            self._setup_done = True
            return

        def run_bucket(_bucket, prompts):
            return llama_greedy_decode(self.params, rank_config, prompts,
                                       max_tokens=tokens, mesh=mesh)

        def collate(_bucket, payloads):
            batch = torch.from_numpy(np.stack(payloads))
            if device.type == "cuda":
                batch = batch.pin_memory()
            return batch.to(device, non_blocking=True)

        def split(results, count):
            generated = results.cpu().numpy()
            return [generated[i].tolist() for i in range(count)]

        self.compute.register_batched(
            self._program, run_bucket, [int(self.prompt_length)],
            collate, split, max_batch=int(max_batch),
            max_wait=float(max_wait))
        self._setup_done = True

    def _setup_continuous(self, config, max_batch: int, mesh=None) -> None:
        """The decoder, its prefix cache and the session table:
        requests join and leave the running batch between decode steps
        (serving.ContinuousDecoder).  The byte budgets (prefix_cache_mb,
        prefix_tenant_mb, host_kv_mb, host_kv_tenant_mb) count the
        model's KV bytes, as the JAX element's do: on a mesh each rank
        holds its head shards of every block, so its budgets are these
        over the KV heads' divisor.  On a mesh the session table's lease
        expiries and idle demotions ride the decoder's round note: rank
        0's clock decides them, and every rank applies them in one
        round."""
        from ..serving import ContinuousDecoder, PrefixKVCache
        # the serving role tags the owning pipeline's discovery record,
        # so role-aware discovery and routing tell prefill, decode and
        # colocated pools apart
        role, _ = self.get_parameter("role", "")
        if role and self.pipeline is not None:
            from ..serving_disagg import tag_role
            tag_role(self.pipeline, str(role))
        steps_per_sync, _ = self.get_parameter("steps_per_sync", 4)
        eos_token, _ = self.get_parameter("eos_token", -1)
        # prefix_block > 0 binds a hash-addressed prefix cache, so shared
        # system prompts and multi-turn histories skip re-prefill.
        # Chunked prefill is forced on (default: one bucket-sized chunk):
        # histories outgrow the prefill bucket, and chunking lifts the
        # prompt cap to max_seq
        prefix_block, _ = self.get_parameter("prefix_block", 0)
        prefill_chunk, _ = self.get_parameter("prefill_chunk", 0)
        self.prefix_cache = None
        shards = 1
        if mesh is not None:
            from ..parallel.sharding import local_config
            shards = config.num_kv_heads // \
                local_config(config, mesh).num_kv_heads

        def budget(megabytes) -> int:
            return int(float(megabytes) * (1 << 20)) // shards

        if int(prefix_block) > 0:
            cache_mb, _ = self.get_parameter("prefix_cache_mb", 64)
            tenant_mb, _ = self.get_parameter("prefix_tenant_mb", 0)
            self.prefix_cache = PrefixKVCache(
                block_tokens=int(prefix_block),
                max_bytes=budget(cache_mb),
                tenant_max_bytes=budget(tenant_mb) or None,
                name=self.definition.name)
            prefill_chunk = int(prefill_chunk) or int(self.prompt_length)
            # the host KV tier: session demotion and LRU pressure demote
            # chain blocks to host memory instead of forgetting them, and
            # the admission / session-touch prefetch re-lands them
            host_kv_mb, _ = self.get_parameter("host_kv_mb", 0)
            if int(host_kv_mb) > 0:
                from ..serving_tiered import HostBlockStore
                host_tenant_mb, _ = self.get_parameter("host_kv_tenant_mb",
                                                       0)
                self.prefix_cache.attach_host_store(HostBlockStore(
                    max_bytes=budget(host_kv_mb),
                    tenant_max_bytes=budget(host_tenant_mb) or None,
                    name=self.definition.name))
        paged, _ = self.get_parameter("paged", False)
        self.decoder = ContinuousDecoder(
            self.params, config, max_slots=max_batch,
            prefill_buckets=(int(self.prompt_length),),
            steps_per_sync=int(steps_per_sync),
            prefill_chunk=int(prefill_chunk) or None,
            eos_token=int(eos_token) if int(eos_token) >= 0 else None,
            name=self.definition.name, prefix_cache=self.prefix_cache,
            paged_kv=parse_bool(paged, False), kv_block=int(prefix_block)
            or 32, device=self.compute.device, mesh=mesh)
        # session-resident conversations: each turn re-submits the
        # session's whole history from the SessionTable and the prefix
        # cache longest-matches it, so a returning session resumes
        # instead of re-prefilling; lease expiry and demotion release
        # the pinned KV through the table's hooks
        sessions, _ = self.get_parameter("sessions", False)
        self._session_table = None
        self._session_view = None
        if parse_bool(sessions, False) and self.prefix_cache is not None:
            from ..state.sessions import SessionTable, SessionView
            session_lease, _ = self.get_parameter("session_lease", 300.0)
            session_shards, _ = self.get_parameter("session_shards", 2)
            session_idle, _ = self.get_parameter("session_idle", 0.0)
            # without a host tier demote_sessions is release_sessions
            self._session_table = SessionTable(
                self.pipeline, num_shards=int(session_shards),
                lease_time=float(session_lease),
                on_expired=self.prefix_cache.demote_sessions,
                on_demoted=self.prefix_cache.demote_sessions,
                demote_idle=float(session_idle) or None,
                agree_lapses=mesh is not None)
            if mesh is not None:
                self.decoder.add_note_hook(
                    self._session_table.take_lapses,
                    self._session_table.apply_lapses,
                    self._session_table.lapses_pending)
            # session_mirror names ANOTHER runtime's SessionTable topic
            # root: its shard deltas replicate here, so a conversation
            # that fails over to this pipeline keeps its history
            mirror, _ = self.get_parameter("session_mirror", "")
            if str(mirror or ""):
                self._session_view = SessionView(
                    self.runtime, str(mirror), int(session_shards))
        # disaggregated serving: a role=prefill runtime computes the
        # prompt KV and ships it; this decoder prefills only the ragged
        # suffix.  The chain lands in the prefix cache, or (cacheless,
        # paged) straight in the pool; without a pool the client
        # prefills locally, never dropping a request
        self._prefill_client = None
        disagg, _ = self.get_parameter("disagg", False)
        if parse_bool(disagg, False) and \
                (self.prefix_cache is not None or self.decoder.paged):
            from ..serving_disagg import PrefillClient
            transfer_timeout, _ = self.get_parameter("disagg_timeout", 5.0)
            disagg_retries, _ = self.get_parameter("disagg_retries", 1)
            self._prefill_client = PrefillClient(
                self.runtime, self.decoder,
                services_cache=getattr(self.pipeline, "_services_cache",
                                       None),
                name=self.definition.name,
                transfer_timeout=float(transfer_timeout),
                retries=int(disagg_retries))

    def start_stream(self, stream) -> None:
        self._setup()
        if self.mode == "continuous":
            # the pump timer lives while any stream is open
            self._open_streams += 1
            if self._open_streams == 1:
                self.decoder.attach(self.runtime.event)
                self.decoder.on_idle = None
                if self._stats_timer is None:
                    self._stats_timer = self.runtime.event.\
                        add_timer_handler(self._publish_serving_stats,
                                          1.0)

    def stop_stream(self, stream) -> None:
        if self.mode == "continuous":
            self._open_streams = max(0, self._open_streams - 1)
            if self._open_streams == 0:
                # in-flight requests must still complete (their frames
                # are parked DEFERRED): detach only once drained
                if self.decoder.idle:
                    self._teardown_continuous()
                else:
                    self.decoder.on_idle = lambda: (
                        self._teardown_continuous()
                        if self._open_streams == 0 else None)

    def _teardown_continuous(self) -> None:
        self._publish_serving_stats()       # final truth, not stale
        if self._stats_timer is not None:
            self.runtime.event.remove_timer_handler(self._stats_timer)
            self._stats_timer = None
        if self._prefill_client is not None:
            self._prefill_client.stop()
            self._prefill_client = None
        if self._session_view is not None:
            self._session_view.terminate()
            self._session_view = None
        if self._session_table is not None:
            self._session_table.stop()
        self.decoder.detach(self.runtime.event)

    def _pad_prompt(self, text):
        tokens = self.tokenizer(str(text)) or [1]
        length = int(self.prompt_length)
        padded = ([0] * max(0, length - len(tokens)) + tokens)[-length:]
        return np.asarray(padded, np.int32)

    def _to_outputs(self, generated):
        return {"response_tokens": generated,
                "response": self.detokenizer(generated)}

    def process_frame(self, frame: Frame, text="", **_) -> FrameOutput:
        self._setup()
        if self.mode == "continuous":
            return self._process_continuous(frame, text)

        prompt = self._pad_prompt(text)
        length = int(self.prompt_length)
        if self.mode == "sync":
            box = {}
            self.compute.submit(self._program, frame.stream_id, prompt,
                                length,
                                lambda _sid, r: box.setdefault("r", r))
            self.compute.programs[self._program].scheduler.drain(
                force=True)
            result = box["r"]
            if isinstance(result, Exception):
                return FrameOutput(False, diagnostic=repr(result))
            return FrameOutput(True, self._to_outputs(result))

        def callback(_sid, result):
            outputs = result if isinstance(result, Exception) else \
                self._to_outputs(result)
            self.pipeline.post("resume_frame", frame,
                               self.definition.name, outputs)

        self.compute.submit(self._program, frame.stream_id, prompt,
                            length, callback)
        return FrameOutput(True, DEFERRED)

    def _process_continuous(self, frame: Frame, text) -> FrameOutput:
        from ..observe.tracing import current_trace
        turn = self.tokenizer(str(text)) or [1]
        # with sessions on, the turn's prompt is the session's WHOLE
        # history plus the new text, which the prefix cache
        # longest-matches: only the new tokens prefill
        tenant_param, _ = self.get_parameter("tenant", "", frame.stream)
        # ONE normalized tenant key for decoder, cache and table
        tenant = _session_key(str(tenant_param or "default"))
        table = self._session_table
        session_id = ""
        history: list = []
        cap = self.decoder.max_seq - self.max_tokens - 2
        if table is not None:
            session_param, _ = self.get_parameter("session", "",
                                                  frame.stream)
            session_id = _session_key(str(session_param or
                                          frame.stream_id))
            payload = table.get(tenant, session_id)
            if isinstance(payload, dict):
                history = [int(t) for t in payload.get("history", ())]
            elif self._session_view is not None:
                # a failover turn: the mirrored state plane knows the
                # session; on_done re-creates it locally
                mirrored = self._session_view.get(tenant, session_id)
                if isinstance(mirrored, dict):
                    history = [int(t) for t in
                               mirrored.get("history", ())]
        tokens = (history + turn)[-cap:] if history else turn[-cap:]
        if history and self.prefix_cache is not None and \
                self.prefix_cache.tiered:
            # the session touch is the earliest promotion kick: a revived
            # conversation's demoted chain starts re-landing now
            self.prefix_cache.prefetch(tenant, tokens)

        def on_done(_rid, generated):
            if table is not None:
                # the finished turn IS the next turn's prefix: pin its
                # chain under the session handle and keep the history in
                # the table; a shed create must release the pin it took
                new_history = (tokens + [int(t) for t in
                                         generated])[-cap:]
                leaf, kv_tokens = self.prefix_cache.session_store(
                    tenant, session_id, new_history)
                if not table.create(tenant, session_id,
                                    {"history": new_history,
                                     "kv": leaf or "",
                                     "kv_tokens": kv_tokens}):
                    self.prefix_cache.session_release(tenant, session_id)
            self.pipeline.post("resume_frame", frame, self.definition.name,
                               self._to_outputs(generated))

        # the frame's deadline rides the ambient TraceContext in
        # engine-clock seconds; the decoder's admission runs on
        # time.monotonic: carry only the remaining budget across (on a
        # mesh rank 0's verdict and deadline decide, at the round note)
        context = current_trace()
        deadline = None
        if context is not None and context.deadline is not None:
            remaining = context.remaining(self.runtime.event.clock.now())
            if remaining is not None:
                deadline = time.monotonic() + max(0.0, remaining)
        request_id = f"{frame.stream_id}.{frame.frame_id}"
        if self._prefill_client is not None:
            # the transfer is asynchronous: a decoder refusal after the
            # KV landed fails the parked frame through resume_frame
            def on_refused(_rid):
                self.pipeline.post(
                    "resume_frame", frame, self.definition.name,
                    RuntimeError("decoder admission shed after prefill "
                                 "transfer: estimated admit wait outruns "
                                 "the remaining deadline budget"))
            accepted = self._prefill_client.submit(
                request_id, tokens, self.max_tokens, on_done,
                deadline=deadline, tenant=tenant, on_refused=on_refused)
        else:
            def on_refused(_rid, reason):
                # a decoder on a mesh refuses at its round note
                self.pipeline.post(
                    "resume_frame", frame, self.definition.name,
                    RuntimeError(f"decoder admission refused ({reason}): "
                                 f"estimated admit wait outruns the "
                                 f"remaining deadline budget"
                                 if reason == "shed" else
                                 f"decoder admission refused ({reason})"))
            accepted = self.decoder.submit(
                request_id, tokens, self.max_tokens, on_done,
                deadline=deadline,
                tenant=tenant if self.prefix_cache is not None else None,
                on_refused=on_refused)
        if not accepted:
            return FrameOutput(False, diagnostic=(
                "decoder admission shed: estimated admit wait outruns "
                "the remaining deadline budget"))
        return FrameOutput(True, DEFERRED)
