#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aiko_services_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device and build: the card's name and power limit (nvidia-smi), and
     the seconds nvcc took to build every kernel from csrc/;
  2. kernels: each kernel against its plain PyTorch version at the shapes
     its path gives it, in bf16, with its stated tolerance (flash at the
     slice phase's batch of 8 and the pipeline's batch of 32); median
     device times (time_ms: the host runs ahead of the card, so the
     events bracket device work alone; the timer line shows a call that
     launches nothing at ~0) of the kernel, the plain version and one
     PyTorch library call
     computing the same function (timed only: the port never calls it),
     and the least time the card could take (bound_ms); cross-decode at
     the decode tail's T = 1536 (bucket 3072) and T = 250 (bucket 500);
     the paged kernel
     at the Llama decode shape, t_cap 256 and 512, natively and with int8
     pools (scales folded), and at the chunked-prefill extend shape (16
     rows of a 64-token chunk, 256 query rows per KV head, offsets drawn
     from [0, 512]) with int8 pools dequantized and natively;
  3. slice: Whisper-small at full width (768 / 12 heads / 12 + 12 layers /
     51,865 vocab), bf16, seeded random weights, served through
     ComputeRuntime + PE_WhisperASR (two elements of one port pipeline,
     fed with submit()): long requests (bucket 3072, audio context 1536,
     the flash kernel) and short ones (bucket 500, plain attention) on
     the int16 and mu-law wires; the launch counts of that run; one long
     request's encoder features with the kernel against the plain
     version;
  4. profile: one steady batch per bucket under torch.profiler (device
     busy time, idle share, launches, the costliest kernels);
  4b. pipeline: examples/speech/pipeline_transcription.json on the port's
     host plane (ProcessRuntime + ComputeRuntime + Pipeline on a virtual
     clock), Whisper-small in bf16 with only the gates opened: 8 short
     streams (1 s chunks, window 3, 4 frames: bucket 500) and 4 long
     ones (10 s chunks, 3 frames of 10 / 20 / 30 s: buckets 1000 and
     3072); every frame completes with tokens and text, PE_Speaker
     collects audio for every stream, the flash kernel launches 12 x the
     bucket-3072 batches, the scheduler coalesces streams (mean batch
     size > 1) and no timer outlives teardown; frames and batches per
     bucket, virtual and wall seconds, first-call and steady seconds;
  4c. remote_pipeline: examples/speech/pipeline_transcription_remote.json
     unedited: a caller runtime whose remote_asr hop crosses the binary
     wire (the i8mel codec the definition names, passed as
     remote_wire_codecs) to a serving pipeline p_transcription_server
     ((PE_WhisperASR (PE_Synthesize)), Whisper-small in bf16 with the
     local example's parameters, behind an AdmissionGate reading the
     scheduler's wait estimate) found through the port's Registrar, three
     runtimes on one broker and a virtual clock: 4 short streams and 2
     long ones, 22 frames; every frame completes with the server's
     tokens, the i8mel bytes that crossed are mel_i8_pack of the
     caller's mel, the wire and admission counters and the hop histogram
     count every frame, the wire made one device-to-host copy per frame,
     flash launches 12 x the bucket-3072 batches at the pipeline's shape,
     no hop is pending and no timer outlives teardown; envelopes and
     bytes each way, hop p50, virtual and wall seconds, the copies'
     seconds;
  4d. peer_pipeline: the same run with the caller's and the server's
     runtime on TCP peer channels (enable_peer(kinds=("tcp",)),
     127.0.0.1): every request and reply envelope of the hop crosses one
     socket and none rides the broker (spies on both topics see none),
     one handshake, the drive advancing the virtual clock only when no
     envelope is on the socket (peer.in_flight); the caller's tokens
     equal remote_pipeline's frame by frame; the channel's envelopes and
     bytes each way, the copies;
  4e. peer_chaos: the same traffic over the same channels under two
     seeded FaultPlans (PEER_CHAOS: the caller's channel drops a fifth
     of its requests, the server's delays half of its replies) with hop
     retries: every frame completes, faults and retries above 0, one
     device-to-host copy per frame sent, tokens equal peer_pipeline's;
  4f. cli: `python -m aiko_services_tpu_torch pipeline show` and
     `params` on both speech examples exit 0; ProcessManager.spawn_python
     starts `pipeline create examples/speech/pipeline_transcription.json
     --PE_MicrophoneSim.limit 3` on the card: the card's free memory
     falls by at least CLI_MIN_FALL_GB while it runs, it does not exit
     on its own, ProcessManager.delete stops it;
  5. llama: Llama-1B at full width (2048 / 32 heads / 8 KV heads / 16
     layers / 128,256 vocab), bf16, seeded random weights, served by the
     paged ContinuousDecoder (16 slots, 16 steps per sync, 32-token
     blocks, prefill bucket 128, max_seq 1024): 24 requests, 8 of them
     submitted after the first round and one long enough to take t_cap
     from 256 to 512; every request completes with its budget, the pool
     drains, the paged kernel launches once per layer per decode step;
     tokens/s, round seconds, and one steady round under torch.profiler;
  6. llama_f32: full width at 2 layers in f32: the paged decoder's greedy
     tokens against llama_greedy_decode (dense cache, plain attention);
  7. llama_int8_chunked: Llama-1B at full width, bf16, with int8 KV pools
     and chunked prefill (chunks of 64, bucket 64, 16 slots, 8 steps per
     sync, 32-token blocks, max_seq 1024): 24 requests of 32 new tokens,
     8 with 16-64 prompt tokens and 16 with 65-640 (the first exactly
     640, so t_cap reaches 768), 8 submitted after the first round; every
     request completes, the pool drains, the folded int8 kernel launches
     16 x decode steps and the dequantizing one 16 x extend dispatches,
     and no call synchronizes the stream beyond each round's one wait
     (torch's sync debug mode); tokens/s, rounds, chunk counts, and one
     round under torch.profiler;
  8. llama_int8_f32: full width at 2 layers in f32, the same decoder with
     4 slots: 4 requests of 40 / 100 / 200 / 300 prompt tokens against
     the same port decoder on the CPU (the kernels' plain versions).
Every earlier phase's launch counts must equal EARLIER_COUNTS.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the run fails before
printing any result.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger
# of its bytes over the memory rate and its operations over the peak.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# A kernel's output against its plain version computed in f32 on the
# same input values.  Elementwise, per output x = sum_j p_j v_j / l:
#   |kernel - plain| <= u * |plain| + c * sum_j p_j |v_j| / l
# u is the output's rounding: 2^-8, bf16's unit roundoff, for the bf16
# outputs of flash and cross-decode; 0 for the paged kernel's f32 output.
# c bounds the kernel's own rounding inside the sum: the flash kernel
# rounds each probability to bf16 for the PV product (c = 2^-8), the
# cross-decode kernel and the paged kernel's split path (the decode rows)
# keep f32 throughout (c = 2^-12 leaves room for f32 sums over 20k keys);
# the paged kernel's tensor-core path (bf16, more than 16 rows: the
# extend rows) rounds each unnormalised probability to bf16 for PV, as
# flash does and as JAX and the plain version round their weights
# (c = 2^-8).  sum_j p_j |v_j| / l is the plain version run on |v|.
# Besides, the relative L2 error of the whole output stays under a
# per-kernel limit, about 2.5x the error that rounding alone gives for
# the bf16 outputs (flash: output and probabilities, ~2^-9 relative each;
# cross-decode: the output's ~2^-9.5; the paged tensor-core path: the
# probabilities', relative errors spread over [-2^-8, 2^-8], ~0.0012 rms,
# under its f32 output) and
# 1e-4 for the paged split path's f32 (one dropped key of T <= 1024 moves
# a row by ~1/sqrt(T)), so that one dropped or mis-weighted key per row
# fails.
BF16_U = 2 ** -8
KERNEL_TOLERANCE = {          # kernel: (u, c, relative L2 limit)
    "flash_attention": (BF16_U, 2 ** -8, 0.008),
    "cross_decode_attention": (BF16_U, 2 ** -12, 0.004),
    "paged_decode_attention": (0.0, 2 ** -12, 1e-4),
    "paged_decode_attention_tensor_cores": (0.0, 2 ** -8, 0.003),
}
# the paged kernel's int8 variants on the split path keep f32 from the
# loaded values on, as the native one does: the same model, held against
# the plain version run in f32 on the values the kernel sees (int8 values
# and f32 scales as they are when folding; the values rounded to bf16,
# round(q * round(s)), when dequantizing)
KERNEL_TOLERANCE["paged_decode_attention_int8_fold"] = \
    KERNEL_TOLERANCE["paged_decode_attention_int8_dequant"] = \
    KERNEL_TOLERANCE["paged_decode_attention"]
# encoder features through 12 bf16 layers, kernel against plain
# attention: each layer's attention differs by about the bf16 rounding of
# the probabilities (2^-9 relative), and 12 residual layers add a few of
# those up: relative L2 error of the features
ENCODER_REL_L2 = 0.03

FLASH_KERNEL_LINE = "aiko_services_tpu/ops/attention.py:21"
# the flash kernel's shape [B, H, S, D] in each phase that launches it:
# bucket 3072 (context 1536) padded to the element's max_batch (8 in the
# slice phase, the example definition's default 32 in the pipeline)
FLASH_SHAPES = {"slice": (8, 12, 1536, 64), "pipeline": (32, 12, 1536, 64)}
# each phase that launches flash, and the row (FLASH_SHAPES key) whose
# shape it must run at: the remote pipeline's server pads to the same
# max_batch of 32 as the local pipeline
FLASH_ROWS = {"slice": "slice", "pipeline": "pipeline",
              "remote_pipeline": "pipeline", "peer_pipeline": "pipeline",
              "peer_chaos": "pipeline"}
# Whisper-small (dim, heads, encoder layers, decoder layers, vocab)
WHISPER_SMALL = (768, 12, 12, 12, 51865)
# flash launches in peer_chaos: 12 x its bucket-3072 batches
PEER_CHAOS_FLASH = 36
# the counts every earlier phase gives (flash in slice, pipeline and the
# remote and peer phases, the paged kernel natively and its two int8
# variants)
EARLIER_COUNTS = {"slice": 12, "pipeline": 24, "remote_pipeline": 24,
                  "peer_pipeline": 24, "peer_chaos": PEER_CHAOS_FLASH,
                  "llama": 5216, "int8_fold": 1920, "int8_dequant": 192}
# peer_chaos: the caller's channel drops a fifth of its request
# envelopes, the server's delays half of its replies by 0.2 s; a hop
# whose 3 s lease expires is sent again, up to 4 times.  Each side's
# plan has its own seed (random.Random(0) draws nothing under 0.2 in its
# first 16 draws: the run would inject no drop)
PEER_CHAOS = {
    "seeds": (2, 1),
    "caller_rules": (("drop", {"topic": "{server}", "probability": 0.2}),),
    "serving_rules": (("delay", {"topic": "{caller}", "probability": 0.5,
                                 "delay": 0.2}),),
    "retries": 4, "timeout": 3.0}
# the CLI child: Whisper-small's ~241 M parameters take ~0.48 GB in bf16
CLI_MIN_FALL_GB = 0.45
CLI_TIMEOUT_S = 240.0
CROSS_KERNEL_LINE = "aiko_services_tpu/ops/attention.py:164"
PAGED_KERNEL_LINE = "aiko_services_tpu/ops/paged_attention.py:59"

# the Llama slice's decoder (bench.py's 1b preset geometry) and traffic
LLAMA_DECODER = {"max_slots": 16, "steps_per_sync": 16, "kv_block": 32,
                 "prefill_buckets": (128,), "max_seq": 1024,
                 "paged_kv": True}
# int8 KV and chunked prefill: the JAX bench's conversation-rung decoder
# (bench.py:1605-1611) without its prefix cache
LLAMA_INT8_DECODER = {"max_slots": 16, "steps_per_sync": 8, "kv_block": 32,
                      "prefill_buckets": (64,), "prefill_chunk": 64,
                      "max_seq": 1024, "paged_kv": True,
                      "kv_cache_dtype": "int8"}
# llama_int8_f32: a first token mismatch against the CPU run passes only
# where the CPU run's top-2 logit gap there is below this.  Two f32 runs
# that sum in other orders store K/V that differ by an ulp or so, and
# where a value sits at a rounding boundary of its int8 code that ulp
# moves the code by one: a change of one scale (max|x| / 127, ~2% of a
# row's largest value) in one stored element.  The run prints the
# largest top-1 logit difference of the two runs before any mismatch
# (the drift) and the smallest top-2 gap of the CPU run: on an H100 they
# were 5.2e-4 and 5.1e-3.  The limit sits about 4x above that drift and
# below that smallest gap, so a token whose gap is wider than any drift
# seen must match.
INT8_TIE_GAP = 2e-3


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def flush_l2(scratch) -> None:
    scratch.zero_()            # 128 MB write evicts the 50 MB L2


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep's device spin per millisecond,
    measured once with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(2_000_000)
    end.record()
    end.synchronize()
    return 2e6 / start.elapsed_time(end)


def time_ms(fn, scratch, reps: int = 20, warmup: int = 3,
            host_ahead: bool = True) -> float:
    """Median device time of one call, cold L2, between two CUDA events
    that bracket device work alone.  After the L2 flush the stream spins
    on the card for 1 ms more than twice the call's host time (the median
    of the warm-up calls), so the host records the start event, runs the
    call's Python (checks, allocations, launches) and records the end
    event while the card is still spinning: the call's kernels then run
    back to back between the events.  host_ahead=False leaves the spin
    out, so the events also take in the host's time between launches
    (only to show what the spin removes)."""
    host = []
    for _ in range(warmup):
        begin = time.perf_counter()
        fn()
        host.append(time.perf_counter() - begin)
    torch.cuda.synchronize()
    spin = int((2e3 * statistics.median(host) + 1.0) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        flush_l2(scratch)
        if host_ahead:
            torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    compute_ms = flops / PEAK_BF16_FLOPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if compute_ms >= memory_ms:
        return compute_ms, "operations"
    return memory_ms, "bytes"


def split_heads(x, heads: int):
    """[B, T, H*D] → [B, H, T, D] view, the layout layers.mha hands the
    attention functions."""
    b, t, _ = x.shape
    return x.view(b, t, heads, -1).permute(0, 2, 1, 3)


def compare(kernel: str, out, plain, plain_on_abs_v) -> dict:
    """The error of a kernel's output against its plain version (both
    callables take (q, k, v) in f32); raises beyond KERNEL_TOLERANCE."""
    torch.cuda.synchronize()
    u, c, rel_l2_limit = KERNEL_TOLERANCE[kernel]
    ref, magnitude = plain(), plain_on_abs_v()
    err = (out.float() - ref).abs()
    rel_l2 = (err.norm() / ref.norm()).item()
    # error over its elementwise bound: at most 1 passes
    bound_ratio = (err / (u * ref.abs() + c * magnitude)
                   .clamp_min(1e-30)).max().item()
    if not torch.isfinite(out).all() or bound_ratio > 1.0 or \
            rel_l2 > rel_l2_limit:
        raise AssertionError(
            f"{kernel}: kernel disagrees with its plain version (max abs "
            f"err {err.max().item()}, error / elementwise bound "
            f"{bound_ratio}, relative L2 {rel_l2}, limit {rel_l2_limit})")
    return {"max_abs_err": err.max().item(), "rel_l2": rel_l2,
            "rel_l2_limit": rel_l2_limit, "bound_ratio": bound_ratio}


def phase_kernels(device, generator) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes;
    returns one record per kernel (the causal flash case, an option the
    path does not take, is printed on its own line)."""
    import torch.nn.functional as F

    from aiko_services_tpu_torch.ops import attention as A

    scratch = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                          device=device)
    b, h, s, d = FLASH_SHAPES["slice"]

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    def record(name, source, replaces, errors, kernel, plain, library,
               flops, nbytes, shape):
        bound_ms, bound_by = bound(flops, nbytes)
        result = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape), **errors,
            "ms": time_ms(kernel, scratch),
            "plain_ms": time_ms(plain, scratch),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(library, scratch),
        }
        emit({"phase": "kernel", **result})
        return result

    # flash attention at the encoder's shape (bucket 3072: context 1536),
    # once per phase that launches it: [B, S, H*D] projections viewed as
    # heads, as layers.mha hands them; the causal case (an option the
    # path does not take) at the slice's batch only
    records = []
    cases = [(phase, shape, False) for phase, shape in FLASH_SHAPES.items()]
    cases.append(("slice", FLASH_SHAPES["slice"], True))
    for phase, (fb, fh, fs, fd), causal in cases:
        q, k, v = (split_heads(randn(fb, fs, fh * fd), fh) for _ in range(3))
        q32, k32, v32 = q.float(), k.float(), v.float()
        errors = compare(
            "flash_attention", A.flash_attention(q, k, v, causal=causal),
            lambda: A.flash_attention_reference(q32, k32, v32,
                                                causal=causal),
            lambda: A.flash_attention_reference(q32, k32, v32.abs(),
                                                causal=causal))
        del q32, k32, v32
        pairs = fs * (fs + 1) / 2 if causal else fs * fs   # keys a run needs
        name = "flash_attention" + ("" if phase == "slice" else f"_b{fb}")
        result = record(
            name + ("_causal" if causal else ""),
            "aiko_services_tpu_torch/csrc/flash_attention.cu",
            FLASH_KERNEL_LINE, errors,
            lambda: A.flash_attention(q, k, v, causal=causal),
            lambda: A.flash_attention_reference(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            flops=4.0 * fb * fh * pairs * fd,
            nbytes=4.0 * fb * fh * fs * fd * 2, shape=(fb, fh, fs, fd))
        if not causal:
            result["counter"] = "flash_attention"
            result["counted_in"] = tuple(
                name for name, row in FLASH_ROWS.items() if row == phase)
            records.append(result)
        del q, k, v
        torch.cuda.empty_cache()

    # cross-decode attention at the decode tail's shapes: one query row
    # against the precomputed cross K/V of the 3072-frame bucket (T =
    # 1536) and of the 500-frame bucket (T = 250)
    for t in (s, 250):
        qd = split_heads(randn(b, 1, h * d), h)
        kd, vd = (split_heads(randn(b, t, h * d), h) for _ in range(2))
        qd32, kd32, vd32 = qd.float(), kd.float(), vd.float()
        errors = compare(
            "cross_decode_attention", A.cross_decode_attention(qd, kd, vd),
            lambda: A.cross_decode_attention_reference(qd32, kd32, vd32),
            lambda: A.cross_decode_attention_reference(qd32, kd32,
                                                       vd32.abs()))
        result = record(
            "cross_decode_attention" + ("" if t == s else f"_t{t}"),
            "aiko_services_tpu_torch/csrc/cross_decode_attention.cu",
            CROSS_KERNEL_LINE, errors,
            lambda: A.cross_decode_attention(qd, kd, vd),
            lambda: A.cross_decode_attention_reference(qd, kd, vd),
            lambda: F.scaled_dot_product_attention(qd, kd, vd),
            flops=4.0 * b * h * t * d,
            nbytes=(2.0 * b * h * t * d + 2.0 * b * h * d) * 2,
            shape=(b, h, t, d))
        result["counter"] = "cross_decode_attention"
        result["counted_in"] = ("slice", "pipeline")
        records.append(result)
    return records


def paged_case(generator, t_cap: int, side_len: int, block: int = 32):
    """Operands of one paged decode-attention call at the Llama slice's
    shape: max_slots slots, 8 KV heads, 4 query rows each (G = 4, W = 1),
    D = 64, bf16, a pool of shuffled blocks, extents from 1 to t_cap, a
    side buffer of side_len entries (the decoder's steps_per_sync) under
    a partial mask."""
    slots, num_kv, groups = LLAMA_DECODER["max_slots"], 8, 4
    nb = t_cap // block
    num_blocks = slots * nb + 1
    device = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    k_pool, v_pool = (randn(num_blocks, num_kv, block, 64) for _ in range(2))
    k_pool[0] = v_pool[0] = 0                     # the null block
    entries = torch.randint(1, t_cap + 1, (slots,), generator=generator,
                            device=device, dtype=torch.int32)
    ids = (torch.randperm(num_blocks - 1, generator=generator,
                          device=device) + 1).to(torch.int32).view(slots, nb)
    needed = (entries.long() + block - 1) // block
    past = torch.arange(nb, device=device)[None] >= needed[:, None]
    tables = ids.masked_fill(past, 0)             # past the extent: null
    side_valid = torch.rand((slots, 1, side_len), generator=generator,
                            device=device) < 0.5
    side_valid[:, :, 0] = True
    return (randn(slots, num_kv, groups, 64), k_pool, v_pool, tables,
            randn(slots, num_kv, side_len, 64),
            randn(slots, num_kv, side_len, 64), side_valid, entries)


def extend_case(generator, block: int = 32):
    """Operands of one chunk extend at the int8 Llama decoder's shape: 16
    rows of a 64-token chunk, 8 KV heads, 4 x 64 query rows each, D = 64,
    bf16; offsets (the pool extents) drawn from [0, 512], row 0's 0 (a
    first chunk); the chunk's own K/V as the side buffer under the causal
    triangle; the table at t_cap 768, null past offset + chunk."""
    chunk = LLAMA_INT8_DECODER["prefill_chunk"]
    slots, num_kv, groups, nb = 16, 8, 4, 768 // block
    num_blocks = slots * nb + 1
    device = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    k_pool, v_pool = (randn(num_blocks, num_kv, block, 64) for _ in range(2))
    k_pool[0] = v_pool[0] = 0
    offsets = torch.randint(0, 513, (slots,), generator=generator,
                            device=device, dtype=torch.int32)
    offsets[0] = 0
    ids = (torch.randperm(num_blocks - 1, generator=generator,
                          device=device) + 1).to(torch.int32).view(slots, nb)
    needed = (offsets.long() + chunk + block - 1) // block
    past = torch.arange(nb, device=device)[None] >= needed[:, None]
    tables = ids.masked_fill(past, 0)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=device).tril()
    side_valid = tri.expand(slots, chunk, chunk).contiguous()
    return (randn(slots, num_kv, groups * chunk, 64), k_pool, v_pool, tables,
            randn(slots, num_kv, chunk, 64), randn(slots, num_kv, chunk, 64),
            side_valid, offsets)


def int8_pool(pool):
    """The int8 serving form of a bf16 pool (null block all zeros)."""
    from aiko_services_tpu_torch.models.layers import quantize_kv_cache
    leaf = quantize_kv_cache(pool)
    leaf["s"][0] = 0
    return leaf


def phase_paged_kernel(generator) -> list[dict]:
    """The paged kernel against its plain version, in its three numerics:
    natively and with int8 pools (scales folded) at the decode shape,
    t_cap 256 and 512; with int8 pools dequantized and natively at the
    extend shape.  Returns every record, for the kernels line.
    library_ms: scaled_dot_product_attention
    over K/V gathered (and dequantized) contiguously beforehand and a
    boolean mask built beforehand (excluded from the time)."""
    import torch.nn.functional as F

    from aiko_services_tpu_torch.models.layers import (dequantize_kv_cache,
                                                       gather_paged_kv)
    from aiko_services_tpu_torch.ops import paged_attention as P

    scratch = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                          device=generator.device)
    scale = 0.125

    # the timer on a call that does the wrapper's host work (its checks
    # and its output allocation) and launches nothing: ~0 ms with the
    # host ahead of the card, the host's time without (operands from a
    # generator of their own, so the rows below keep theirs)
    idle = paged_case(torch.Generator(device=generator.device).manual_seed(1),
                      256, LLAMA_DECODER["steps_per_sync"])

    def host_only():
        kq, ks, vq, vs = P._check_planes(idle[1], idle[2])
        P._check_operands(idle[0], kq, ks, vq, vs, *idle[3:], 4)
        torch.empty(idle[0].shape, dtype=torch.float32, device=idle[0].device)

    emit({"phase": "timer", "host_only_call_ms": time_ms(host_only, scratch),
          "host_only_call_ms_without_spin": time_ms(host_only, scratch,
                                                    host_ahead=False),
          "spin_cycles_per_ms": spin_cycles_per_ms()})

    def measure(name, variant, operands, groups, fold, extra):
        q, k_pool, v_pool, tables, k_side, v_side, side_valid, entries = \
            operands
        int8 = isinstance(k_pool, dict)
        # the plain version in f32 on the values the kernel sees
        if int8 and not fold:
            plain_k, plain_v = (dequantize_kv_cache(leaf, q.dtype).float()
                                for leaf in (k_pool, v_pool))
        elif int8:
            plain_k, plain_v = k_pool, v_pool
        else:
            plain_k, plain_v = k_pool.float(), v_pool.float()
        q32, ks32, vs32 = q.float(), k_side.float(), v_side.float()

        def plain_f32(abs_v=False):
            v_main, v_s = plain_v, vs32
            if abs_v:
                v_main = dict(v_main, q=v_main["q"].abs()) \
                    if isinstance(v_main, dict) else v_main.abs()
                v_s = vs32.abs()
            return P.paged_decode_attention_reference(
                q32, plain_k, v_main, tables, ks32, v_s, side_valid,
                entries, groups=groups, scale=scale, fold_scales=fold)

        slots, num_kv, rows, _ = q.shape
        tensor_cores = P.kernel_plan(True, slots, num_kv, rows, 1, 1)[0] \
            == P.TENSOR_PATH
        errors = compare(
            "paged_decode_attention_tensor_cores" if tensor_cores
            else variant,
            P.paged_decode_attention(*operands, groups=groups,
                                     fold_scales=fold),
            plain_f32, lambda: plain_f32(abs_v=True))
        # SDPA's operands, made outside the timed call
        k_all = torch.cat([dequantize_kv_cache(
            gather_paged_kv(k_pool, tables), q.dtype), k_side], dim=2)
        v_all = torch.cat([dequantize_kv_cache(
            gather_paged_kv(v_pool, tables), q.dtype), v_side], dim=2)
        width = side_valid.shape[1]
        block = (k_pool["q"] if int8 else k_pool).shape[2]
        main_t = tables.shape[1] * block
        main_ok = torch.arange(main_t, device=q.device)[None] < \
            entries[:, None]
        side_rows = side_valid[:, torch.arange(rows, device=q.device) %
                               width]                    # [S, rows, P]
        mask = torch.cat([main_ok[:, None].expand(-1, rows, -1), side_rows],
                         dim=-1)[:, None]
        # bytes and operations this run's data needs: the blocks each
        # slot's extent covers (1 byte a value and 4 a position for the
        # scales when int8), the side buffer, q, the table and the f32
        # output; a product per (query row, covered position) and per
        # visible (query row, side entry)
        positions = int(((entries.long() + block - 1) // block).sum()) * \
            block
        per_position = 64 + 4 if int8 else 64 * 2
        nbytes = (q.numel() * 2 + 2 * positions * num_kv * per_position +
                  2 * k_side.numel() * 2 + side_valid.numel() +
                  tables.numel() * 4 + entries.numel() * 4 +
                  slots * num_kv * rows * 64 * 4)
        side_pairs = int(side_valid.sum()) * groups
        flops = 4.0 * num_kv * 64 * (rows * positions + side_pairs)
        bound_ms, bound_by = bound(flops, nbytes)
        record = {
            "name": name, "route": "cuda",
            "source": "aiko_services_tpu_torch/csrc/"
                      "paged_decode_attention.cu",
            "replaces": PAGED_KERNEL_LINE, "variant": variant, **extra,
            "shape": list(q.shape), **errors,
            "ms": time_ms(lambda: P.paged_decode_attention(
                *operands, groups=groups, fold_scales=fold), scratch),
            "plain_ms": time_ms(lambda: P.paged_decode_attention_reference(
                *operands, groups=groups, scale=scale, fold_scales=fold),
                scratch),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k_all, v_all, attn_mask=mask), scratch),
        }
        emit({"phase": "kernel", **record})
        return record

    # each row at the side-buffer length of the decoder that runs it:
    # the native decoder's steps_per_sync (16), the int8 one's (8);
    # "path" keys the launches the smoke's decoders make at that shape
    records = []
    for t_cap in (256, 512):
        suffix = "" if t_cap == 256 else f"_t{t_cap}"
        operands = paged_case(generator, t_cap,
                              LLAMA_DECODER["steps_per_sync"])
        records.append(measure("paged_decode_attention" + suffix,
                               "paged_decode_attention", operands, 4, True,
                               {"t_cap": t_cap, "path": "decode"}))
        quantized = list(paged_case(generator, t_cap,
                                    LLAMA_INT8_DECODER["steps_per_sync"]))
        quantized[1], quantized[2] = int8_pool(quantized[1]), \
            int8_pool(quantized[2])
        records.append(measure("paged_decode_attention_int8_fold" + suffix,
                               "paged_decode_attention_int8_fold", quantized,
                               4, True, {"t_cap": t_cap, "path": "decode"}))
    operands = extend_case(generator)
    quantized = list(operands)
    quantized[1], quantized[2] = int8_pool(operands[1]), \
        int8_pool(operands[2])
    records.append(measure("paged_decode_attention_int8_dequant",
                           "paged_decode_attention_int8_dequant", quantized,
                           4, False, {"t_cap": 768, "path": "extend"}))
    # no smoke decoder extends into a native pool: this row's launches
    # stay 0
    records.append(measure("paged_decode_attention_extend",
                           "paged_decode_attention", operands, 4, False,
                           {"t_cap": 768, "path": "extend"}))
    return records


def speech_like(rng, seconds: float, sample_rate: int = 16000):
    """A seeded int16 signal with speech-like structure: a few drifting
    harmonics under an amplitude envelope, plus noise."""
    import numpy as np
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    f0 = 110.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 6))
    signal = 0.3 * voice * envelope + 0.02 * rng.standard_normal(t.shape)
    return np.clip(signal * 16384.0, -32768, 32767).astype(np.int16)


class plain_flash:
    """Within this block the dispatcher's flash path runs the kernel's
    plain version instead of the kernel: the kernel-vs-plain comparison
    of the encoder features (the port itself never does this)."""

    def __enter__(self):
        from aiko_services_tpu_torch.ops import attention as A
        self._module, self._kernel = A, A.flash_attention
        A.flash_attention = lambda q, k, v, causal=False, scale=None: \
            A.flash_attention_reference(q, k, v, causal=causal, scale=scale)

    def __exit__(self, *exc):
        self._module.flash_attention = self._kernel
        return False


class flash_shapes:
    """Within this block every shape the dispatcher hands the flash
    wrapper is recorded in `seen`; the wrapper itself runs unchanged and
    keeps its own launch count."""

    def __enter__(self):
        from aiko_services_tpu_torch.ops import attention as A
        self._module, self._kernel = A, A.flash_attention
        self.seen = set()

        def recorded(q, k, v, **kwargs):
            self.seen.add(tuple(q.shape))
            return self._kernel(q, k, v, **kwargs)
        A.flash_attention = recorded
        return self

    def __exit__(self, *exc):
        self._module.flash_attention = self._kernel
        return False


def check_flash_shapes(phase: str, seen: set) -> list:
    """The flash kernel ran at the shape its kernels-line row was
    compared and timed at, and at no other."""
    shape = FLASH_SHAPES[FLASH_ROWS[phase]]
    if seen != {shape}:
        raise AssertionError(f"{phase}: flash ran at {sorted(seen)}, its "
                             f"row holds {shape}")
    return list(shape)


def covered_ms(spans) -> float:
    """Milliseconds covered by the union of (name, start us, end us)
    spans."""
    total, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda span: span[1]):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def profile_batch(label: str, submit, scheduler) -> dict:
    """One batch through the scheduler under torch.profiler: host wall
    time, the summed device time of its kernels (one stream, so they do
    not overlap), the device's idle share, and the kernels that take the
    most device time.  Device figures are None when the profiler records
    no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        submit()
        scheduler.drain(force=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name, launches = {}, 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            launches += 1
            by_name[event.name] = by_name.get(event.name, 0.0) + \
                event.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda item: -item[1])[:8]
    return {"batch": label, "wall_s": wall,
            "device_busy_s": busy_ms / 1e3 if launches else None,
            "idle_share": 1.0 - busy_ms / 1e3 / wall if launches else None,
            "device_launches": launches,
            "flash_ms": sum(ms for name, ms in by_name.items()
                            if "flash_attention_kernel" in name),
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def host_runtime():
    """A port ProcessRuntime on its own event engine (virtual clock) and
    in-memory broker, with a ComputeRuntime on the card."""
    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.transport import MemoryBroker, MemoryMessage

    broker = MemoryBroker()

    def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
        return MemoryMessage(on_message=on_message, broker=broker,
                             lwt_topic=lwt_topic, lwt_payload=lwt_payload,
                             lwt_retain=lwt_retain)
    runtime = ProcessRuntime(name="chip_smoke",
                             engine=EventEngine(VirtualClock()),
                             transport_factory=transport).initialize()
    return runtime, ComputeRuntime(runtime, "compute")


def phase_slice() -> dict:
    """Serve Whisper-small requests through ComputeRuntime +
    PE_WhisperASR; returns the kernel launch counts of that run."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.whisper import (
        encode, greedy_decode_from_audio)
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops.audio import log_mel_spectrogram
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  parse_pipeline_definition)

    runtime, compute = host_runtime()
    parameters = {
        "preset": "small", "frontend": "audio", "buckets": [500, 1000, 3000],
        "max_batch": 8, "pad_batch": True, "max_tokens": 24,
        # random weights give near-uniform token distributions, which
        # the hallucination gates would suppress; the smoke checks the
        # decode itself, so the gates are opened
        "logprob_threshold": -1e9, "compression_ratio_threshold": 1e9,
    }
    # two ASR elements (the int16 and mu-law wires) as the heads of one
    # pipeline; requests reach them through submit(), outside a walk
    elements = [{"name": name, "parameters": element_parameters,
                 "input": [{"name": "audio"}],
                 "output": [{"name": "tokens"}, {"name": "text"}],
                 "deploy": {"local": {"class_name": "PE_WhisperASR"}}}
                for name, element_parameters in (
                    ("asr", parameters),
                    ("asr_mulaw", {**parameters, "wire": "mulaw"}))]
    pipeline = Pipeline(runtime, parse_pipeline_definition({
        "version": 0, "name": "p_slice", "runtime": "python",
        "graph": ["(asr)", "(asr_mulaw)"], "elements": elements}))
    start = time.perf_counter()
    asr = pipeline.graph.node("asr").element
    asr_mulaw = pipeline.graph.node("asr_mulaw").element
    asr_scheduler, mulaw_scheduler = asr.scheduler, asr_mulaw.scheduler
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    config = asr.config
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != (768, 12, 12, 12, 51865):
        raise AssertionError(f"not Whisper-small: {config}")
    if asr.buckets != [500, 1000, 3072]:
        raise AssertionError(f"buckets {asr.buckets} != [500, 1000, 3072]")

    rng = np.random.default_rng(0)
    long_audio = [speech_like(rng, s) for s in (25.0, 27.0, 28.5, 30.0)]
    short_audio = [speech_like(rng, s) for s in (2.6, 3.0, 3.4)]
    mulaw_audio = [speech_like(rng, 3.1)]

    def serve_round():
        results = {}

        def keep(sid, result):
            results[sid] = result
        for i, audio in enumerate(long_audio):
            asr.submit(f"long{i}", keep, audio=audio)
        for i, audio in enumerate(short_audio):
            asr.submit(f"short{i}", keep, audio=audio)
        for i, audio in enumerate(mulaw_audio):
            asr_mulaw.submit(f"mulaw{i}", keep, audio=audio)
        asr_scheduler.drain(force=True)
        mulaw_scheduler.drain(force=True)
        torch.cuda.synchronize()
        return results

    # the main path's run: counts set to 0 just before, read just after
    for name in A.launches:
        A.launches[name] = 0
    dispatch_before = dict(A.dispatch_stats)
    start = time.perf_counter()
    with flash_shapes() as shapes:
        results = serve_round()
    first_round_s = time.perf_counter() - start
    counts = dict(A.launches)
    flash_shape = check_flash_shapes("slice", shapes.seen)
    dispatched = {key: A.dispatch_stats[key] - dispatch_before[key]
                  for key in dispatch_before}

    expected = len(long_audio) + len(short_audio) + len(mulaw_audio)
    if len(results) != expected:
        raise AssertionError(f"{len(results)} answers for {expected} "
                             f"requests")
    for sid, result in results.items():
        if isinstance(result, Exception):
            raise AssertionError(f"request {sid} failed: {result!r}")
        tokens = np.asarray(result["tokens"])
        if tokens.size == 0 or tokens.min() < 0 or \
                tokens.max() >= config.n_vocab:
            raise AssertionError(f"request {sid}: tokens {tokens}")
        if not isinstance(result["text"], str) or \
                not math.isfinite(result["avg_logprob"]):
            raise AssertionError(f"request {sid}: bad result {result}")
    long_batches = -(-len(long_audio) // 8)
    expected_flash = config.enc_layers * long_batches
    if counts["flash_attention"] != expected_flash:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= 12 x {long_batches} long-audio batches")

    # steady batches: the same requests again
    serve_round()
    steady = {}
    for name in ("whisper_asr.asr", "whisper_asr.asr_mulaw"):
        for bucket, seconds in compute.programs[name].recent_service:
            steady.setdefault(f"{name}:{bucket}", []).append(seconds)
    first_calls = {f"{name}:{bucket}": seconds
                   for name in ("whisper_asr.asr", "whisper_asr.asr_mulaw")
                   for bucket, seconds in
                   compute.programs[name].first_call_times.items()}

    # where a steady batch's time goes, per bucket
    profiles = [
        profile_batch("asr:3072", lambda: [
            asr.submit(f"p{i}", lambda *_: None, audio=audio)
            for i, audio in enumerate(long_audio)], asr_scheduler),
        profile_batch("asr:500", lambda: [
            asr.submit(f"p{i}", lambda *_: None, audio=audio)
            for i, audio in enumerate(short_audio)], asr_scheduler)]

    # one long request's encoder features: kernel against plain version
    pcm = np.zeros((1, 3072 * 160), np.int16)
    pcm[0, :long_audio[0].shape[0]] = long_audio[0]
    bucket_config = dataclasses.replace(config, n_audio_ctx=1536)
    with torch.inference_mode():
        mel = log_mel_spectrogram(
            torch.from_numpy(pcm).cuda().float() / 32768.0).to(config.dtype)
        with_kernel = encode(asr.params, bucket_config, mel)
        with plain_flash():
            with_plain = encode(asr.params, bucket_config, mel)
        torch.cuda.synchronize()
        diff = with_kernel.float() - with_plain.float()
        rel_l2 = (diff.norm() / with_plain.float().norm()).item()
        max_abs = diff.abs().max().item()
        if with_kernel.shape != (1, 1536, 768) or \
                not torch.isfinite(with_kernel).all() or \
                not rel_l2 <= ENCODER_REL_L2:
            raise AssertionError(f"encoder kernel vs plain: rel L2 {rel_l2} "
                                 f"(limit {ENCODER_REL_L2}), max abs "
                                 f"{max_abs}, shape "
                                 f"{tuple(with_kernel.shape)}")
        kwargs = dict(max_tokens=24, suppress_timestamps=True)
        tokens_kernel, _, _ = greedy_decode_from_audio(
            asr.params, bucket_config, with_kernel, **kwargs)
        tokens_plain, _, _ = greedy_decode_from_audio(
            asr.params, bucket_config, with_plain, **kwargs)
        agreement = (tokens_kernel == tokens_plain).float().mean().item()

    emit({"phase": "slice", "requests": len(results),
          "setup_s": setup_s, "first_round_s": first_round_s,
          "first_call_s": first_calls,
          "steady_batch_s": {key: statistics.median(values)
                             for key, values in steady.items()},
          "launches": counts, "dispatch": dispatched,
          "flash_launches_expected": expected_flash,
          "flash_shape": flash_shape,
          "encoder_rel_l2": rel_l2, "encoder_max_abs": max_abs,
          "encoder_rel_l2_limit": ENCODER_REL_L2,
          "token_agreement_kernel_vs_plain": agreement,
          "sample_tokens": {sid: np.asarray(r["tokens"])[:6].tolist()
                            for sid, r in sorted(results.items())[:2]},
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    for record in profiles:
        emit({"phase": "profile", **record})
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    return counts


def phase_pipeline() -> dict:
    """examples/speech/pipeline_transcription.json on the port, driven on
    a virtual clock (PE_MicrophoneSim → PE_AudioFraming → PE_LogMel on the
    card → PE_WhisperASR, Whisper-small in bf16 → PE_Synthesize →
    PE_Speaker); returns the kernel launch counts of that run."""
    import numpy as np

    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.pipeline import (Pipeline,
                                                  load_pipeline_definition)

    runtime, compute = host_runtime()
    engine = runtime.event
    definition = load_pipeline_definition(
        "examples/speech/pipeline_transcription.json")
    # only the hallucination gates change: random weights give
    # near-uniform logprobs
    definition.parameters.update({
        "PE_WhisperASR.logprob_threshold": -1e9,
        "PE_WhisperASR.compression_ratio_threshold": 1e9})
    pipeline = Pipeline(runtime, definition, stream_lease_time=0)
    done = []
    pipeline.add_frame_handler(done.append)
    # 8 short streams with the example's parameters (1 s chunks, window
    # 3: frames of 1-3 s, bucket 500) and 4 long ones (10 s chunks:
    # frames of 10, 20 and 30 s, buckets 1000 and 3072)
    streams = {f"short{i}": {"PE_MicrophoneSim.limit": 4,
                             "PE_MicrophoneSim.frequency": 220.0 + 40 * i}
               for i in range(8)}
    streams.update({f"long{i}": {"PE_MicrophoneSim.chunk_seconds": 10.0,
                                 "PE_AudioFraming.window_count": 3,
                                 "PE_MicrophoneSim.limit": 3,
                                 "PE_MicrophoneSim.frequency": 180.0 + 70 * i}
                    for i in range(4)})
    expected = 8 * 4 + 4 * 3
    start = time.perf_counter()
    # the main path's run: counts set to 0 just before, read just after
    for name in A.launches:
        A.launches[name] = 0
    for stream_id, parameters in streams.items():
        pipeline.create_stream(stream_id, parameters=parameters,
                               lease_time=0)
    asr = pipeline.graph.node("PE_WhisperASR").element
    with flash_shapes() as shapes:
        while len(done) < expected and engine.clock.now() < 60.0:
            while engine.step():
                pass
            engine.clock.advance(0.01)
        torch.cuda.synchronize()
    counts = dict(A.launches)
    wall_s = time.perf_counter() - start
    virtual_s = engine.clock.now()

    config = asr.config
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != WHISPER_SMALL or \
            asr.buckets != [500, 1000, 3072]:
        raise AssertionError(f"not Whisper-small in buckets [500, 1000, "
                             f"3072]: {config}, {asr.buckets}")
    failed = pipeline.recovery_stats["frames_failed"]
    if len(done) != expected or failed:
        raise AssertionError(f"{len(done)} of {expected} frames completed, "
                             f"{failed} failed")
    scheduler = asr.scheduler
    frames_per_bucket = {}
    for frame in done:
        tokens = np.asarray(frame.swag["tokens"])
        if tokens.size == 0 or tokens.min() < 0 or \
                tokens.max() >= config.n_vocab or \
                not isinstance(frame.swag["text"], str) or \
                "time_PE_WhisperASR" not in frame.metrics:
            raise AssertionError(f"frame {frame.stream_id}:{frame.frame_id}"
                                 f": tokens {tokens}, swag "
                                 f"{sorted(frame.swag)}, metrics "
                                 f"{sorted(frame.metrics)}")
        bucket = scheduler.buckets.bucket_for(frame.swag["mel"].shape[0])
        frames_per_bucket[bucket] = frames_per_bucket.get(bucket, 0) + 1
    speaker = {sid: stream.variables.get("speaker.audio")
               for sid, stream in pipeline.streams.items()}
    if sorted(sid for sid, audio in speaker.items()
              if audio is not None and audio.size) != sorted(streams):
        heard = [sid for sid, audio in speaker.items() if audio is not None]
        raise AssertionError(f"PE_Speaker collected audio for {heard}")
    program = compute.programs["whisper_asr.PE_WhisperASR"]
    batches_per_bucket = {bucket: 1 for bucket in program.first_call_times}
    steady = {}
    for bucket, seconds in program.recent_service:
        batches_per_bucket[bucket] += 1
        steady.setdefault(bucket, []).append(seconds)
    long_batches = batches_per_bucket.get(3072, 0)
    expected_flash = config.enc_layers * long_batches
    if not long_batches or counts["flash_attention"] != expected_flash:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= 12 x {long_batches} bucket-3072 batches")
    flash_shape = check_flash_shapes("pipeline", shapes.seen)
    mean_batch = scheduler.mean_batch_size()
    if not mean_batch > 1:
        raise AssertionError(f"mean batch size {mean_batch}: no coalescing")
    for stream_id in list(pipeline.streams):
        pipeline.destroy_stream(stream_id)
    # no microphone tick and no stream lease outlives its stream; the
    # rest (the compute runtime's timers) goes with the runtime
    stream_timers = [handler for handler in engine.live_timer_handlers()
                     if "start_stream" in getattr(handler, "__qualname__", "")
                     or type(getattr(handler, "__self__", None)).__name__
                     == "Lease"]
    share = dict(compute.ec_producer.share)
    pipeline.stop()
    compute.stop()
    runtime.terminate()
    live_timers = engine.live_timer_handlers()
    if stream_timers or live_timers:
        raise AssertionError(f"timers left after teardown: stream "
                             f"{stream_timers}, all {live_timers}")
    emit({"phase": "pipeline", "streams": len(streams), "frames": len(done),
          "frames_failed": failed,
          "frames_per_bucket": frames_per_bucket,
          "batches_per_bucket": batches_per_bucket,
          "mean_batch_size": mean_batch, "launches": counts,
          "flash_launches_expected": expected_flash,
          "flash_shape": flash_shape,
          "virtual_s": virtual_s, "wall_s": wall_s,
          "first_call_s": share.get("first_call", {}),
          "steady_batch_s": {bucket: statistics.median(values)
                             for bucket, values in steady.items()},
          "live_timers_after_teardown": len(live_timers),
          "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return counts


def profile_round(decoder, label: str = "llama decode") -> dict:
    """One pump round under torch.profiler: host wall time, the device
    time its kernels cover, the idle share, the paged kernel's share and
    calls, the costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aiko_services_tpu_torch.ops import paged_attention as P

    torch.cuda.synchronize()
    calls_before = sum(P.launches.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        decoder.pump()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    paged_calls = sum(P.launches.values()) - calls_before
    by_name, spans = {}, []
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            spans.append((event.name, event.time_range.start,
                          event.time_range.end))
            by_name[event.name] = by_name.get(event.name, 0.0) + \
                event.time_range.elapsed_us() / 1e3
    # the split path's merge kernel starts before the split kernel ends
    # (programmatic dependent launch): busy time is the union of the
    # kernels' spans, not their sum
    busy_ms = covered_ms(spans)
    top = sorted(by_name.items(), key=lambda item: -item[1])[:8]
    # the paged wrapper's kernels: the split path (split + merge) and the
    # tensor-core path, [device ms (union of spans), calls]
    paged = {path: [covered_ms([s for s in spans
                                if any(k in s[0] for k in kernels)]),
                    sum(1 for s in spans if kernels[0] in s[0])]
             for path, kernels in (
                 ("split", ("paged_split_kernel", "paged_combine_kernel")),
                 ("tensor_cores", ("paged_mma_kernel",)))}
    return {"round": label, "wall_s": wall,
            "device_busy_s": busy_ms / 1e3 if spans else None,
            "idle_share": 1.0 - busy_ms / 1e3 / wall if spans else None,
            "device_launches": len(spans),
            "paged_kernel_ms": sum(ms for ms, _ in paged.values()),
            "paged_ms_calls": paged, "paged_calls": paged_calls,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def llama_traffic(rng, vocab: int) -> list:
    """24 requests (id, prompt, max_new): 16–128 seeded prompt tokens and
    24–64 new tokens each, the first a 128-token prompt asking 320 new
    tokens, whose context takes t_cap from 256 to 512."""
    requests = [("long", rng.integers(0, vocab, 128).tolist(), 320)]
    for i in range(23):
        prompt = rng.integers(0, vocab, int(rng.integers(16, 129)))
        requests.append((f"r{i}", prompt.tolist(),
                         int(rng.integers(24, 65))))
    return requests


def phase_llama() -> int:
    """Serve Llama-1B requests through the paged ContinuousDecoder;
    returns the paged kernel's launches in that run."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024)
    if (config.dim, config.num_heads, config.num_kv_heads, config.num_layers,
            config.ffn_dim, config.vocab) != (2048, 32, 8, 16, 8192, 128256):
        raise AssertionError(f"not the 1b preset: {config}")
    start = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    decoder = ContinuousDecoder(params, config, **LLAMA_DECODER)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    requests = llama_traffic(np.random.default_rng(0), config.vocab)
    budgets = {rid: new for rid, _, new in requests}
    done = {}

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    # the main path's run: counts set to 0 just before, read just after
    P.launches["paged_decode_attention"] = 0
    start = time.perf_counter()
    for rid, prompt, new in requests[:16]:
        decoder.submit(rid, prompt, new, keep)
    round_s, t_caps = [], []
    while True:
        round_start = time.perf_counter()
        decoder.pump()
        round_s.append(time.perf_counter() - round_start)
        t_caps.append(decoder._cache_t)
        if len(round_s) == 1:
            for rid, prompt, new in requests[16:]:
                decoder.submit(rid, prompt, new, keep)
        if decoder.idle:
            break
        if len(round_s) > 500:
            raise AssertionError("the decoder did not drain in 500 rounds")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = P.launches["paged_decode_attention"]
    stats = dict(decoder.stats)

    if sorted(done) != sorted(budgets):
        raise AssertionError(f"{len(done)} of {len(budgets)} completed")
    for rid, tokens in done.items():
        if len(tokens) != budgets[rid] or \
                not all(0 <= t < config.vocab for t in tokens):
            raise AssertionError(f"request {rid}: {len(tokens)} tokens of "
                                 f"{budgets[rid]}")
    if decoder.pool.used_blocks() != 0:
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"still owned after the run")
    if launches != config.num_layers * stats["steps"]:
        raise AssertionError(f"paged kernel launches {launches} != "
                             f"{config.num_layers} x {stats['steps']} steps")
    if max(t_caps) != 512:
        raise AssertionError(f"t_cap reached {max(t_caps)}, not 512")
    generated = sum(len(tokens) for tokens in done.values())
    memory_gb = torch.cuda.max_memory_allocated() / 1e9

    # one steady decode round of 16 fresh requests under the profiler
    rng = np.random.default_rng(1)
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(0, config.vocab, 64).tolist(),
                       40, lambda *_: None)
    decoder.pump()                 # admits
    decoder.pump()                 # first decode round
    profile = profile_round(decoder)
    while not decoder.idle:
        decoder.pump()
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("pool blocks still owned after the profile")

    emit({"phase": "llama", "requests": len(done), "tokens": generated,
          "setup_s": setup_s, "wall_s": wall,
          "tokens_per_s": generated / wall, "rounds": len(round_s),
          "first_round_s": round_s[0],
          "steady_round_s": statistics.median(round_s[2:]),
          "round_s": round_s, "t_cap": t_caps, "steps": stats["steps"],
          "paged_launches": launches,
          "paged_launches_expected": config.num_layers * stats["steps"],
          "useful_steps": stats["useful_steps"],
          "wasted_steps": stats["wasted_steps"],
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "pool_blocks": decoder.pool.num_blocks - 1,
          "kv_cache_bytes": decoder.kv_cache_bytes(),
          "max_memory_gb": memory_gb,
          "sample_tokens": {rid: done[rid][:6] for rid in ("long", "r0")}})
    emit({"phase": "profile", **profile})
    return launches


def phase_llama_f32() -> dict:
    """Full width at 2 layers in f32: the paged decoder's greedy tokens
    against llama_greedy_decode (dense cache, plain attention).  A
    mismatch whose reference top-2 logit gap is under 1e-4 is printed as
    a tie; any other fails."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import (
        LLAMA_PRESETS, llama_forward, llama_greedy_decode, llama_init)
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    # f32 products in full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                 dtype=torch.float32, max_seq_len=1024)
    params = llama_init(torch.Generator(device="cuda").manual_seed(1),
                        config)
    decoder = ContinuousDecoder(params, config, **{**LLAMA_DECODER,
                                                   "max_slots": 4})
    rng = np.random.default_rng(2)
    prompts = {f"f{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (20, 57, 100, 128)}
    max_new = 24
    done = {}
    for rid, prompt in prompts.items():
        decoder.submit(rid, prompt, max_new,
                       lambda r, t: done.update({r: list(t)}))
    while not decoder.idle:
        decoder.pump()
    ties, identical = [], 0
    with torch.inference_mode():
        for rid, prompt in prompts.items():
            ref = llama_greedy_decode(
                params, config, torch.tensor([prompt], device="cuda"),
                max_tokens=max_new)[0].tolist()
            got = done[rid]
            if got == ref:
                identical += 1
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            logits = llama_forward(params, config, torch.tensor(
                [prompt + ref[:i]], device="cuda"))[0, -1]
            top2 = torch.topk(logits, 2).values
            gap = (top2[0] - top2[1]).item()
            if gap >= 1e-4:
                raise AssertionError(
                    f"f32 request {rid}: paged token {got[i]} != dense "
                    f"{ref[i]} at step {i}, top-2 gap {gap}")
            ties.append({"request": rid, "step": i, "gap": gap})
    record = {"phase": "llama_f32", "requests": len(prompts),
              "identical": identical, "ties": ties,
              "pool_blocks_used": decoder.pool.used_blocks()}
    emit(record)
    return record


def int8_traffic(rng, vocab: int) -> list:
    """24 requests (id, prompt, max_new) of 32 new tokens: 16 with 65-640
    prompt tokens (chunked; the first exactly 640) and 8 with 16-64
    (bucketed), in the order they are submitted: 10 chunked and 6
    bucketed first, the other 8 after the first round."""
    chunked = [640] + [int(n) for n in rng.integers(65, 641, 15)]
    short = [int(n) for n in rng.integers(16, 65, 8)]
    lengths = chunked[:10] + short[:6] + chunked[10:] + short[6:]
    return [(f"{'c' if n > 64 else 's'}{i}", rng.integers(0, vocab,
                                                          n).tolist(), 32)
            for i, n in enumerate(lengths)]


def count_extends(decoder) -> list:
    """Count the decoder's chunk-extend dispatches (one launch of the
    dequantizing kernel per layer each) by wrapping its _extend_group;
    returns the one-element counter."""
    dispatches = [0]
    extend_group = decoder._extend_group

    def counted(*args, **kwargs):
        dispatches[0] += 1
        return extend_group(*args, **kwargs)

    decoder._extend_group = counted
    return dispatches


def phase_llama_int8_chunked() -> dict:
    """Serve Llama-1B requests through the paged ContinuousDecoder with
    int8 KV pools and chunked prefill; returns the paged kernel's
    launches per variant in that run."""
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init
    from aiko_services_tpu_torch.ops import paged_attention as P
    from aiko_services_tpu_torch.serving import ContinuousDecoder

    config = dataclasses.replace(LLAMA_PRESETS["1b"], dtype=torch.bfloat16,
                                 max_seq_len=1024)
    if (config.dim, config.num_heads, config.num_kv_heads, config.num_layers,
            config.ffn_dim, config.vocab) != (2048, 32, 8, 16, 8192, 128256):
        raise AssertionError(f"not the 1b preset: {config}")
    start = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(0),
                        config)
    decoder = ContinuousDecoder(params, config, **LLAMA_INT8_DECODER)
    dispatches = count_extends(decoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start

    requests = int8_traffic(np.random.default_rng(3), config.vocab)
    budgets = {rid: new for rid, _, new in requests}
    done = {}

    def keep(request_id, tokens):
        done[request_id] = list(tokens)

    # the main path's run: counts set to 0 just before, read just after.
    # torch's sync debug mode warns at every call that synchronizes the
    # stream (a copy from pageable memory, .item(), nonzero); the round's
    # own wait, on the event behind its device-to-host copy, is not one
    # of them, so the decoder must make none
    for name in P.launches:
        P.launches[name] = 0
    start = time.perf_counter()
    for rid, prompt, new in requests[:16]:
        decoder.submit(rid, prompt, new, keep)
    round_s, t_caps = [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            while True:
                round_start = time.perf_counter()
                decoder.pump()
                round_s.append(time.perf_counter() - round_start)
                t_caps.append(decoder._cache_t)
                if len(round_s) == 1:
                    for rid, prompt, new in requests[16:]:
                        decoder.submit(rid, prompt, new, keep)
                if decoder.idle:
                    break
                if len(round_s) > 500:
                    raise AssertionError(
                        "the decoder did not drain in 500 rounds")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    syncs = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    if syncs:
        raise AssertionError(f"the decoder synchronized the stream beyond "
                             f"its one wait a round: {dict(syncs)}")
    launches = dict(P.launches)
    extends = dispatches[0]
    stats = dict(decoder.stats)

    if sorted(done) != sorted(budgets):
        raise AssertionError(f"{len(done)} of {len(budgets)} completed")
    for rid, tokens in done.items():
        if len(tokens) != budgets[rid] or \
                not all(0 <= t < config.vocab for t in tokens):
            raise AssertionError(f"request {rid}: {len(tokens)} tokens of "
                                 f"{budgets[rid]}")
    if decoder.pool.used_blocks() != 0:
        raise AssertionError(f"{decoder.pool.used_blocks()} pool blocks "
                             f"still owned after the run")
    expected = {"paged_decode_attention": 0,
                "paged_decode_attention_int8_fold":
                    config.num_layers * stats["steps"],
                "paged_decode_attention_int8_dequant":
                    config.num_layers * extends}
    if launches != expected or not extends:
        raise AssertionError(f"paged kernel launches {launches} != "
                             f"{expected} ({stats['steps']} decode steps, "
                             f"{extends} extend dispatches)")
    if max(t_caps) != 768:
        raise AssertionError(f"t_cap reached {max(t_caps)}, not 768")
    generated = sum(len(tokens) for tokens in done.values())
    memory_gb = torch.cuda.max_memory_allocated() / 1e9

    # one steady round under the profiler: 12 slots decoding, 4 long
    # prompts mid-prefill (one extend of width 4)
    rng = np.random.default_rng(4)
    for i in range(16):
        decoder.submit(f"p{i}", rng.integers(
            0, config.vocab, 300 if i < 4 else 64).tolist(), 40,
            lambda *_: None)
    decoder.pump()                 # admits, first chunks
    decoder.pump()                 # first decode round, second chunks
    profile = profile_round(decoder, "llama int8 decode + extend")
    while not decoder.idle:
        decoder.pump()
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("pool blocks still owned after the profile")

    emit({"phase": "llama_int8_chunked", "requests": len(done),
          "tokens": generated, "setup_s": setup_s, "wall_s": wall,
          "tokens_per_s": generated / wall, "rounds": len(round_s),
          "first_round_s": round_s[0],
          "steady_round_s": statistics.median(round_s[2:]),
          "round_s": round_s, "t_cap": t_caps, "steps": stats["steps"],
          "extend_dispatches": extends, "launches": launches,
          "launches_expected": expected,
          "stream_syncs": sum(syncs.values()),
          "prefill_chunks": stats["prefill_chunks"],
          "chunk_admits": stats["chunk_admits"],
          "prefills": stats["prefills"],
          "round_prefill_tokens_max": stats["round_prefill_tokens_max"],
          "useful_steps": stats["useful_steps"],
          "wasted_steps": stats["wasted_steps"],
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "pool_blocks": decoder.pool.num_blocks - 1,
          "kv_cache_bytes": decoder.kv_cache_bytes(),
          "max_memory_gb": memory_gb,
          "sample_tokens": {rid: done[rid][:6] for rid in ("c0", "s10")}})
    emit({"phase": "profile", **profile})
    return launches


class LogitGaps:
    """Records, per slot, the top-1 logit and the top-2 gap behind every
    token a decoder emits (first tokens from admits and extends, then the
    decode steps'), by wrapping layers.linear_logits, the decoder's step
    and its admit and extend programs.  Each slot must serve one request
    for the slot lists to be that request's tokens."""

    def __init__(self, decoder):
        from aiko_services_tpu_torch import serving
        from aiko_services_tpu_torch.models import layers
        self.by_slot = {slot: [] for slot in range(decoder.max_slots)}
        self._calls = []
        self._layers, self._serving = layers, serving
        self._saved = (layers.linear_logits, serving._paged_admit,
                       serving._paged_extend)
        linear_logits, admit, extend = self._saved

        def recording_logits(params, x):
            logits = linear_logits(params, x)
            top = torch.topk(logits.reshape(-1, logits.shape[-1]), 2).values
            self._calls.append(torch.stack([top[:, 0], top[:, 0] -
                                            top[:, 1]], dim=1).cpu())
            return logits

        def first_tokens(rows, slots, emits):
            for j in torch.nonzero(emits.cpu()).flatten().tolist():
                self.by_slot[int(slots[j])].append(rows[j].tolist())

        def recording_admit(*args):
            firsts = admit(*args)
            first_tokens(self._calls[-1], args[8].cpu(), args[9])
            return firsts

        def recording_extend(*args, **kwargs):
            firsts = extend(*args, **kwargs)
            first_tokens(self._calls[-1], args[8].cpu(), args[9] & args[10])
            return firsts

        step = decoder._step

        def recording_step(*args, **kwargs):
            before = len(self._calls)
            out = step(*args, **kwargs)
            for k, active in enumerate(out[1].cpu()):
                rows = self._calls[before + k]
                for slot in torch.nonzero(active).flatten().tolist():
                    self.by_slot[slot].append(rows[slot].tolist())
            return out

        layers.linear_logits = recording_logits
        serving._paged_admit = recording_admit
        serving._paged_extend = recording_extend
        decoder._step = recording_step

    def close(self) -> None:
        (self._layers.linear_logits, self._serving._paged_admit,
         self._serving._paged_extend) = self._saved


def serve_with_gaps(params, config, device, prompts, max_new) -> tuple:
    """(tokens by request, [top-1 logit, top-2 gap] per emitted token by
    request) of the int8 chunked decoder at 4 slots."""
    from aiko_services_tpu_torch.serving import ContinuousDecoder
    decoder = ContinuousDecoder(params, config, device=device, **{
        **LLAMA_INT8_DECODER, "max_slots": len(prompts)})
    gaps = LogitGaps(decoder)
    done = {}
    try:
        for rid, prompt in prompts.items():
            decoder.submit(rid, prompt, max_new,
                           lambda r, t: done.update({r: list(t)}))
        requests = list(decoder._pending)
        while not decoder.idle:
            decoder.pump()
    finally:
        gaps.close()
    if decoder.pool.used_blocks() != 0:
        raise AssertionError("int8 f32 run left pool blocks owned")
    return done, {r.request_id: gaps.by_slot[r.slot] for r in requests}


def phase_llama_int8_f32() -> dict:
    """Full width at 2 layers in f32, int8 KV pools and chunked prefill:
    the decoder on the card against the same port decoder on the CPU (the
    kernels' plain versions) with the same weights.  A first mismatch
    whose CPU top-2 logit gap is under INT8_TIE_GAP is printed as a tie;
    any other fails."""
    import copy
    import dataclasses

    import numpy as np

    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS, llama_init

    # f32 products in full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(LLAMA_PRESETS["1b"], num_layers=2,
                                 dtype=torch.float32, max_seq_len=1024)
    params = llama_init(torch.Generator(device="cuda").manual_seed(2),
                        config)
    cpu_params = copy.deepcopy(params).cpu()
    rng = np.random.default_rng(5)
    prompts = {f"i{n}": rng.integers(0, config.vocab, n).tolist()
               for n in (40, 100, 200, 300)}
    max_new = 16
    start = time.perf_counter()
    got, gpu_gaps = serve_with_gaps(params, config, "cuda", prompts,
                                    max_new)
    card_s = time.perf_counter() - start
    start = time.perf_counter()
    with torch.inference_mode():
        ref, cpu_gaps = serve_with_gaps(cpu_params, config, "cpu", prompts,
                                        max_new)
    cpu_s = time.perf_counter() - start
    ties, identical, drift = [], 0, 0.0
    for rid in prompts:
        if len(got[rid]) != max_new or len(ref[rid]) != max_new:
            raise AssertionError(f"int8 f32 request {rid}: {len(got[rid])} "
                                 f"/ {len(ref[rid])} tokens of {max_new}")
        mismatch = next((i for i, (a, b) in enumerate(zip(got[rid],
                                                          ref[rid]))
                         if a != b), None)
        agreed = max_new if mismatch is None else mismatch
        for (top_card, _), (top_cpu, _) in zip(gpu_gaps[rid][:agreed],
                                               cpu_gaps[rid][:agreed]):
            drift = max(drift, abs(top_card - top_cpu))
        if mismatch is None:
            identical += 1
            continue
        gap = cpu_gaps[rid][mismatch][1]
        if gap >= INT8_TIE_GAP:
            raise AssertionError(
                f"int8 f32 request {rid}: card token {got[rid][mismatch]} "
                f"!= CPU {ref[rid][mismatch]} at step {mismatch}, CPU "
                f"top-2 gap {gap} >= {INT8_TIE_GAP}")
        ties.append({"request": rid, "step": mismatch, "gap": gap})
    record = {"phase": "llama_int8_f32", "requests": len(prompts),
              "identical": identical, "ties": ties,
              "tie_gap_limit": INT8_TIE_GAP,
              "top1_logit_drift_before_mismatch": drift,
              "min_cpu_gap": min(g for rid in prompts
                                 for _, g in cpu_gaps[rid]),
              "card_s": card_s, "cpu_s": cpu_s}
    emit(record)
    return record


def phase_remote_pipeline() -> tuple:
    """examples/speech/pipeline_transcription_remote.json on the port,
    unedited: the caller's remote_asr hop crosses the binary wire, with
    the i8mel codec, to a serving pipeline p_transcription_server
    ((PE_WhisperASR (PE_Synthesize)), Whisper-small in bf16 on the card,
    behind an AdmissionGate reading the scheduler's wait estimate) that
    the caller finds through the registrar.  Registrar, server and
    caller are three runtimes on one broker and one engine under a
    virtual clock.  Returns the kernel launch counts of that run and the
    caller's tokens by (stream, frame)."""
    return remote_transcription("remote_pipeline")


def phase_peer_pipeline(reference: dict) -> tuple:
    """The remote_pipeline phase's run with one change: the caller's and
    the server's runtime both call enable_peer(kinds=("tcp",)) on
    127.0.0.1, so every request and reply envelope of the hop crosses a
    real TCP socket and none rides the broker.  The caller's tokens must
    equal `reference` (the remote_pipeline phase's) frame by frame."""
    return remote_transcription("peer_pipeline", peer={},
                                reference=reference)


def phase_peer_chaos(reference: dict) -> tuple:
    """The peer_pipeline phase's traffic over the same TCP channels with
    a seeded FaultPlan on each side's channel: the caller's drops a fifth
    of its request envelopes, the server's delays half of its replies by
    0.2 s; the caller retries a hop whose 3 s lease expires (up to 4
    times).  Every frame completes, with the tokens of `reference` (the
    peer_pipeline phase's)."""
    return remote_transcription("peer_chaos", peer=PEER_CHAOS,
                                reference=reference)


def remote_transcription(phase: str, peer: dict | None = None,
                         reference: dict | None = None) -> tuple:
    """The remote transcription example's run for the remote_pipeline
    phase (peer None: the hop rides the broker) and the peer phases
    (peer: {} for clean TCP channels, or PEER_CHAOS's fault rules,
    retries and lease).  Returns the kernel launch counts of that run and
    the caller's tokens by (stream, frame)."""
    import numpy as np

    from aiko_services_tpu_torch.compute import ComputeRuntime
    from aiko_services_tpu_torch.event import EventEngine, VirtualClock
    from aiko_services_tpu_torch.observe.metrics import default_registry
    from aiko_services_tpu_torch.ops import attention as A
    from aiko_services_tpu_torch.ops.admission import AdmissionGate
    from aiko_services_tpu_torch.ops.audio import mel_i8_pack, mel_i8_unpack
    from aiko_services_tpu_torch.pipeline import (
        Pipeline, load_pipeline_definition, parse_pipeline_definition)
    from aiko_services_tpu_torch.process import ProcessRuntime
    from aiko_services_tpu_torch.registrar import Registrar
    from aiko_services_tpu_torch.share import ServicesCache
    from aiko_services_tpu_torch.transport import (MemoryBroker,
                                                   MemoryMessage, wire)
    from aiko_services_tpu_torch.transport.chaos import FaultPlan
    from aiko_services_tpu_torch.transport.peer import in_flight

    engine, broker = EventEngine(VirtualClock()), MemoryBroker()

    def runtime(name):
        def transport(on_message, lwt_topic, lwt_payload, lwt_retain):
            return MemoryMessage(on_message=on_message, broker=broker,
                                 lwt_topic=lwt_topic,
                                 lwt_payload=lwt_payload,
                                 lwt_retain=lwt_retain)
        return ProcessRuntime(name=name, engine=engine,
                              transport_factory=transport).initialize()

    def settle():
        while engine.step():
            pass

    reg_rt = runtime("reg")
    registrar = Registrar(reg_rt)
    engine.clock.advance(2.1)           # past the 2.0 s primary search
    settle()
    if not registrar.is_primary:
        raise AssertionError("the registrar did not become primary")

    # the peer phases: one seeded FaultPlan on each side's channel (no
    # rule in peer_pipeline), a TCP endpoint on 127.0.0.1 for both
    chaos = peer or {}
    plans = tuple(FaultPlan(seed=seed)
                  for seed in chaos.get("seeds", (0, 1)))
    hosts = ()

    # the server: PE_WhisperASR with the local example's parameters and
    # only the hallucination gates opened, then PE_Synthesize
    serve_rt = runtime("serve")
    if peer is not None:
        serve_host = serve_rt.enable_peer(
            kinds=("tcp",), fault_plan=plans[1] if peer else None)
    compute = ComputeRuntime(serve_rt, "compute")
    local = load_pipeline_definition(
        "examples/speech/pipeline_transcription.json")
    parameters = {key: value for key, value in local.parameters.items()
                  if key.startswith("PE_WhisperASR.")}
    parameters.update({"PE_WhisperASR.logprob_threshold": -1e9,
                       "PE_WhisperASR.compression_ratio_threshold": 1e9})
    server_definition = parse_pipeline_definition({
        "version": 0, "name": "p_transcription_server", "runtime": "jax",
        "graph": ["(PE_WhisperASR (PE_Synthesize))"],
        "parameters": parameters,
        "elements": [
            {"name": "PE_WhisperASR", "input": [{"name": "mel"}],
             "output": [{"name": "tokens"}, {"name": "text"}]},
            {"name": "PE_Synthesize", "input": [{"name": "text"}],
             "output": [{"name": "audio"}]}]})
    gate = AdmissionGate(inflight_limit=128, metrics_labels={
        "pipeline": "p_transcription_server"})
    server = Pipeline(serve_rt, server_definition, stream_lease_time=0,
                      auto_create_streams=True, admission=gate)
    asr = server.graph.node("PE_WhisperASR").element
    gate.watch_scheduler(asr.scheduler)         # sets the model up
    served, served_by_mel = {}, {}

    def serve(frame):
        tokens = np.asarray(frame.swag["tokens"])
        served.setdefault((frame.stream_id, frame.frame_id), tokens)
        # what the server received: the i8mel-unpacked mel, which names
        # the caller's frame whatever order the frames arrived in
        served_by_mel.setdefault(
            (frame.stream_id, np.asarray(frame.swag["mel"]).tobytes()),
            tokens)
    server.add_frame_handler(serve)

    # the caller: the example, unedited; its wire_codecs parameter is
    # read by no run time, so it is passed as remote_wire_codecs
    call_rt = runtime("call")
    if peer is not None:
        call_host = call_rt.enable_peer(
            kinds=("tcp",), fault_plan=plans[0] if peer else None)
        hosts = (call_host, serve_host)
    definition = load_pipeline_definition(
        "examples/speech/pipeline_transcription_remote.json")
    codecs = dict(definition.parameters["wire_codecs"])
    caller = Pipeline(call_rt, definition,
                      services_cache=ServicesCache(call_rt),
                      stream_lease_time=0,
                      remote_timeout=chaos.get("timeout", 60.0),
                      remote_retries=chaos.get("retries", 0), retry_seed=3,
                      remote_wire_codecs=codecs)
    topics = {"server": f"{server.topic_path}/in",
              "caller": caller.topic_in}
    for plan, rules in zip(plans, (chaos.get("caller_rules", ()),
                                   chaos.get("serving_rules", ()))):
        for kind, rule in rules:
            getattr(plan, kind)(**{**rule,
                                   "topic": rule["topic"].format(**topics)})
    # every envelope to the server and back, as it crossed: on the
    # broker (spies on both topics) and, in the peer phases, as each
    # side's peer host handed it to its runtime
    requests, replies = [], []
    broker_requests, broker_replies = [], []
    for topic, into in ((topics["server"], broker_requests),
                        (topics["caller"], broker_replies)):
        spy = MemoryMessage(
            on_message=lambda _topic, payload, into=into: into.append(
                (engine.clock.now(), payload)), broker=broker)
        spy.connect()
        spy.subscribe(topic)
    if peer is None:
        requests, replies = broker_requests, broker_replies
    else:
        for rt, topic, into in ((serve_rt, topics["server"], requests),
                                (call_rt, topics["caller"], replies)):
            # the peer host calls runtime._on_transport_message for each
            # envelope off its channel (the broker holds the bound
            # method it was given at initialize)
            def delivered(topic_in, payload, ack=None, rt=rt, topic=topic,
                          into=into, deliver=rt._on_transport_message):
                if topic_in == topic:
                    into.append((engine.clock.now(), payload))
                deliver(topic_in, payload, ack)
            rt._on_transport_message = delivered
    settle()
    if not caller.remote_elements_ready():
        raise AssertionError("remote_asr was not discovered")
    if peer is not None:
        # the dial thread pins the caller's end, the accept thread the
        # server's: both before any frame
        deadline = time.monotonic() + 30.0
        while not (call_host.pinned(topics["server"]) and
                   serve_host.pinned(topics["caller"])):
            if time.monotonic() > deadline:
                raise AssertionError(f"no TCP channel: {call_host.info()}"
                                     f", {serve_host.info()}")
            settle()
            time.sleep(0.001)
    done, finished = [], {}

    def completed(frame):
        done.append(frame)
        finished[(frame.stream_id, frame.frame_id)] = engine.clock.now()
    caller.add_frame_handler(completed)

    # 4 short streams (1 s chunks, window 3: frames of 1-3 s, bucket
    # 500) and 2 long ones (10 s chunks: 10, 20, 30 s, buckets 1000 and
    # 3072)
    streams = {f"short{i}": {"PE_MicrophoneSim.limit": 4,
                             "PE_MicrophoneSim.frequency": 220.0 + 40 * i}
               for i in range(4)}
    streams.update({f"long{i}": {"PE_MicrophoneSim.chunk_seconds": 10.0,
                                 "PE_AudioFraming.window_count": 3,
                                 "PE_MicrophoneSim.limit": 3,
                                 "PE_MicrophoneSim.frequency": 180.0 + 70 * i}
                    for i in range(2)})
    expected = 4 * 4 + 2 * 3
    registry = default_registry()

    def wire_count(kind, pipeline, direction):
        return registry.value(f"pipeline_wire_{kind}_total",
                              {"pipeline": pipeline,
                               "direction": direction})

    def admission_count(family):
        return sum(metric.value for labels, metric in
                   registry.series(f"admission_{family}_total")
                   if labels.get("pipeline") == "p_transcription_server")
    before = {"request_envelopes": wire_count(
                  "envelopes", caller.name, "request"),
              "request_frames": wire_count("frames", caller.name, "request"),
              "reply_envelopes": wire_count(
                  "envelopes", server.name, "reply"),
              "reply_frames": wire_count("frames", server.name, "reply"),
              "admitted": admission_count("admitted"),
              "shed": admission_count("shed")}
    hops = registry.histogram("pipeline_hop_seconds",
                              labels={"pipeline": caller.name})
    hops_before = hops.count
    start = time.perf_counter()
    virtual_start = engine.clock.now()
    in_flight_waits = 0
    # the main path's run: counts set to 0 just before, read just after
    for name in A.launches:
        A.launches[name] = 0
    wire.host_copies.update(count=0, seconds=0.0)
    for stream_id, stream_parameters in streams.items():
        caller.create_stream(stream_id, parameters=stream_parameters,
                             lease_time=0)
    with flash_shapes() as shapes:
        while len(done) < expected and \
                engine.clock.now() - virtual_start < 60.0:
            settle()
            # the sockets deliver in wall time: the virtual clock waits
            # for every envelope on a socket to reach its engine
            while in_flight(hosts):
                in_flight_waits += 1
                time.sleep(0.0002)
                settle()
            engine.clock.advance(0.01)
        torch.cuda.synchronize()
    counts = dict(A.launches)
    copies = dict(wire.host_copies)
    wall_s = time.perf_counter() - start
    virtual_s = engine.clock.now() - virtual_start

    config = asr.config
    if (config.dim, config.num_heads, config.enc_layers, config.dec_layers,
            config.n_vocab) != WHISPER_SMALL or \
            asr.buckets != [500, 1000, 3072]:
        raise AssertionError(f"not Whisper-small in buckets [500, 1000, "
                             f"3072]: {config}, {asr.buckets}")
    failed = caller.recovery_stats["frames_failed"]
    if len(done) != expected or failed:
        raise AssertionError(f"{len(done)} of {expected} frames completed, "
                             f"{failed} failed; server "
                             f"{dict(server.recovery_stats)}")
    retries = caller.recovery_stats["retries"]
    # what crossed: each request's mel is i8mel of the caller's own mel,
    # and the tokens merged at the caller are the server's
    crossed, sent_at, request_bytes = {}, {}, 0
    for when, payload in requests:
        request_bytes += len(payload)
        expr, buffers = wire.read_envelope(payload)
        entries = expr[1] if expr[0] == "process_frames_remote" \
            else [expr[1:]]
        for entry in entries:
            marker = entry[1]["mel"]
            if marker[5] != "i8mel":
                raise AssertionError(f"mel crossed as {marker}")
            crossed.setdefault(entry[0], []).append(
                bytes(buffers[int(marker[1])]))
            sent_at.setdefault(entry[0], []).append(when)
    frames_per_bucket, mel_bytes, hop_virtual, tokens_by_key = {}, 0, [], {}
    scheduler = asr.scheduler
    for frame in done:
        key = (frame.stream_id, frame.frame_id)
        swag = frame.swag
        tokens = np.asarray(swag["tokens"])
        tokens_by_key[key] = tokens
        mel = swag["mel"]
        if mel.device.type != "cuda":
            raise AssertionError(f"frame {key}: mel on {mel.device}")
        packed = mel_i8_pack(mel.cpu().numpy())
        if peer is None:
            served_tokens = served.get(key)
            crossed_ok = crossed[frame.stream_id][frame.frame_id] == \
                packed.tobytes()
            hop_virtual.append(finished[key] -
                               sent_at[frame.stream_id][frame.frame_id])
        else:
            # a retried request reaches the server after later frames of
            # its stream: match the served frame by the mel it received
            served_tokens = served_by_mel.get(
                (frame.stream_id, mel_i8_unpack(packed).tobytes()))
            crossed_ok = packed.tobytes() in crossed[frame.stream_id]
        if served_tokens is None or \
                not np.array_equal(tokens, served_tokens):
            raise AssertionError(f"frame {key}: caller tokens {tokens}, "
                                 f"server {served_tokens}")
        if not crossed_ok:
            raise AssertionError(f"frame {key}: the bytes that crossed are "
                                 f"not mel_i8_pack of the caller's mel")
        if reference is not None and \
                not np.array_equal(tokens, reference.get(key)):
            raise AssertionError(f"frame {key}: tokens {tokens}, the "
                                 f"reference phase's {reference.get(key)}")
        if tokens.size == 0 or tokens.min() < 0 or \
                tokens.max() >= config.n_vocab or \
                not isinstance(swag["text"], str) or not swag["text"] or \
                not np.asarray(swag["audio"]).size:
            raise AssertionError(f"frame {key}: tokens {tokens}, swag "
                                 f"{sorted(swag)}")
        mel_bytes += mel.numel() * 4
        bucket = scheduler.buckets.bucket_for(mel.shape[0])
        frames_per_bucket[bucket] = frames_per_bucket.get(bucket, 0) + 1
    wire_counts = {
        "request_envelopes": wire_count("envelopes", caller.name,
                                        "request"),
        "request_frames": wire_count("frames", caller.name, "request"),
        "reply_envelopes": wire_count("envelopes", server.name, "reply"),
        "reply_frames": wire_count("frames", server.name, "reply"),
        "admitted": admission_count("admitted"),
        "shed": admission_count("shed")}
    wire_counts = {key: value - before[key]
                   for key, value in wire_counts.items()}
    dropped = plans[0].stats["drop"]
    for direction in ("request", "reply"):
        envelopes = wire_counts[f"{direction}_envelopes"]
        if not 0 < envelopes <= expected + retries:
            raise AssertionError(f"{envelopes} {direction} envelopes for "
                                 f"{expected} frames")
    # each retry sends its frame again; a dropped envelope never arrives
    if wire_counts["request_frames"] != expected + retries or \
            len(requests) + dropped != wire_counts["request_envelopes"]:
        raise AssertionError(f"wire counts {wire_counts}, "
                             f"{len(requests)} request envelopes seen, "
                             f"{dropped} dropped, {retries} retries")
    if wire_counts["admitted"] != expected or wire_counts["shed"] or \
            server.recovery_stats["shed_early"]:
        raise AssertionError(f"admission: {wire_counts}, server "
                             f"{dict(server.recovery_stats)}")
    if hops.count - hops_before != expected:
        raise AssertionError(f"pipeline_hop_seconds counted "
                             f"{hops.count - hops_before} hops")
    if caller._pending_remote:
        raise AssertionError(f"hops pending: {list(caller._pending_remote)}")
    # one device-to-host copy per frame the wire encoded
    if copies["count"] != wire_counts["request_frames"]:
        raise AssertionError(f"{copies['count']} device-to-host copies on "
                             f"the wire for "
                             f"{wire_counts['request_frames']} frames sent")
    channel = {}
    if peer is not None:
        if broker_requests or broker_replies:
            raise AssertionError(
                f"{len(broker_requests)} requests and {len(broker_replies)}"
                f" replies of the hop rode the broker")
        call_stats, serve_stats = dict(call_host.stats), \
            dict(serve_host.stats)
        ends = [getattr(end, "inner", end) for host in hosts
                for end in host._channels.values()]
        if [end.kind for end in ends] != ["tcp", "tcp"] or \
                call_stats["handshakes"] != 1 or call_stats["fallback"] or \
                serve_stats["fallback"]:
            raise AssertionError(f"peer channels {[e.info() for e in ends]}"
                                 f", caller {call_stats}, server "
                                 f"{serve_stats}")
        if len(replies) != wire_counts["reply_envelopes"]:
            raise AssertionError(f"{len(replies)} replies off the channel, "
                                 f"{wire_counts['reply_envelopes']} sent")
        injected = (dict(plans[0].stats), dict(plans[1].stats))
        if peer and not (dropped and retries and plans[1].stats["delay"]):
            raise AssertionError(f"faults {injected}, {retries} retries")
        channel = {
            "kind": "tcp", "handshakes": call_stats["handshakes"],
            "request_envelopes_on_channel": len(requests),
            "reply_envelopes_on_channel": len(replies),
            "request_bytes_on_channel": request_bytes,
            "reply_bytes_on_channel": sum(len(p) for _, p in replies),
            "broker_envelopes_of_the_hop":
                len(broker_requests) + len(broker_replies),
            "caller_host": {k: call_stats[k] for k in
                            ("sent", "received", "fallback", "tx_shed")},
            "server_host": {k: serve_stats[k] for k in
                            ("sent", "received", "fallback", "tx_shed")},
            "faults_injected": injected,
            "in_flight_waits": in_flight_waits}
    program = compute.programs["whisper_asr.PE_WhisperASR"]
    batches = {bucket: 1 for bucket in program.first_call_times}
    for bucket, _ in program.recent_service:
        batches[bucket] += 1
    long_batches = batches.get(3072, 0)
    expected_flash = config.enc_layers * long_batches
    if not long_batches or counts["flash_attention"] != expected_flash:
        raise AssertionError(f"flash launches {counts['flash_attention']} "
                             f"!= 12 x {long_batches} bucket-3072 batches")
    flash_shape = check_flash_shapes(phase, shapes.seen)
    mean_batch = scheduler.mean_batch_size()
    for pipeline in (caller, server):
        for stream_id in list(pipeline.streams):
            pipeline.destroy_stream(stream_id)
    caller.stop()
    server.stop()
    compute.stop()
    for rt in (call_rt, serve_rt, reg_rt):
        rt.terminate()
    live_timers = engine.live_timer_handlers()
    if live_timers:
        raise AssertionError(f"timers left after teardown: {live_timers}")
    reply_bytes = sum(len(payload) for _, payload in replies)
    record = {
        "phase": phase, "streams": len(streams),
        "frames": len(done), "frames_failed": failed,
        "frames_per_bucket": frames_per_bucket,
        "batches_per_bucket": batches, "mean_batch_size": mean_batch,
        "wire": wire_counts,
        "frames_per_request_envelope":
            wire_counts["request_frames"] / wire_counts["request_envelopes"],
        "frames_per_reply_envelope":
            wire_counts["reply_frames"] / wire_counts["reply_envelopes"],
        "request_bytes_per_frame": request_bytes / expected,
        "f32_mel_bytes_per_frame": mel_bytes / expected,
        "reply_bytes_per_frame": reply_bytes / expected,
        "virtual_s": virtual_s, "wall_s": wall_s,
        "device_to_host_copies": copies["count"],
        "device_to_host_copy_s": copies["seconds"],
        "device_to_host_copy_max_share_of_wall":
            copies["seconds"] / wall_s,
        "launches": counts, "flash_launches_expected": expected_flash,
        "flash_shape": flash_shape,
        "live_timers_after_teardown": len(live_timers)}
    if peer is None:
        record["hop_p50_virtual_s"] = statistics.median(hop_virtual)
    else:
        record.update({"channel": channel, "retries": retries,
                       "recovery": dict(caller.recovery_stats),
                       "tokens_equal_reference_frames": len(done)})
    emit(record)
    return counts, tokens_by_key


def phase_cli() -> dict:
    """The port's command line on the card: `pipeline show` and `pipeline
    params` on both speech examples (four children started together,
    each exiting 0); then the port's ProcessManager.spawn_python starts
    `python -m aiko_services_tpu_torch pipeline create
    examples/speech/pipeline_transcription.json --PE_MicrophoneSim.limit
    3`, whose ComputeRuntime takes the card (device None).  While it runs
    the card's free memory, as this process reads it, falls by at least
    CLI_MIN_FALL_GB (Whisper-small's ~241 M parameters in bf16); the
    child must not exit on its own, and ProcessManager.delete stops it."""
    import subprocess
    import threading

    from aiko_services_tpu_torch.event import EventEngine
    from aiko_services_tpu_torch.process_manager import ProcessManager

    module = "aiko_services_tpu_torch"
    examples = ("examples/speech/pipeline_transcription.json",
                "examples/speech/pipeline_transcription_remote.json")
    start = time.perf_counter()
    children = [(command, path, subprocess.Popen(
                    [sys.executable, "-m", module, "pipeline", command, path],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
                for command in ("show", "params") for path in examples]
    shown = {}
    for command, path, child in children:
        out, err = child.communicate(timeout=120)
        if child.returncode != 0 or not out:
            raise AssertionError(f"pipeline {command} {path}: exit "
                                 f"{child.returncode}: {err[-2000:]}")
        shown[f"{command} {os.path.basename(path)}"] = len(out.splitlines())
    show_s = time.perf_counter() - start

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free_before, total = torch.cuda.mem_get_info()
    exits = []
    engine = EventEngine()
    manager = ProcessManager(
        engine, process_exit_handler=lambda *exit: exits.append(exit))
    lines, errors = [], []
    pid = manager.spawn_python(
        "cli", module, ["pipeline", "create", examples[0],
                        "--PE_MicrophoneSim.limit", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    child = manager.processes["cli"]
    spawned = time.perf_counter()
    readers = [threading.Thread(target=lambda stream=stream, into=into:
                                into.extend(stream), daemon=True)
               for stream, into in ((child.stdout, lines),
                                    (child.stderr, errors))]
    for reader in readers:
        reader.start()
    fall_gb, started_s = 0.0, None
    try:
        deadline = spawned + CLI_TIMEOUT_S
        while time.perf_counter() < deadline:
            engine.step()           # the manager polls its child here
            if exits:
                raise AssertionError(f"the CLI child exited on its own: "
                                     f"{exits}: {''.join(errors)[-3000:]}")
            fall_gb = max(fall_gb, (free_before -
                                    torch.cuda.mem_get_info()[0]) / 1e9)
            if started_s is None and lines:
                started_s = time.perf_counter() - spawned
            if started_s is not None and fall_gb >= CLI_MIN_FALL_GB:
                break
            time.sleep(0.1)
        # it keeps running, streams done, until it is stopped
        hold = time.perf_counter() + 3.0
        while time.perf_counter() < hold:
            engine.step()
            time.sleep(0.1)
        if exits or child.poll() is not None:
            raise AssertionError(f"the CLI child exited on its own: "
                                 f"{exits}: {''.join(errors)[-3000:]}")
    finally:
        ran_s = time.perf_counter() - spawned
        manager.delete("cli")
        manager.terminate()
    for reader in readers:
        reader.join(timeout=10)
    if fall_gb < CLI_MIN_FALL_GB or not lines:
        raise AssertionError(f"the CLI child took {fall_gb:.3f} GB of the "
                             f"card, printed {lines}: "
                             f"{''.join(errors)[-3000:]}")
    if not lines[0].startswith("pipeline p_transcription on "):
        raise AssertionError(f"the CLI child's start line: {lines[0]!r}")
    # ProcessManager.delete (as in JAX) reports no exit to the handler:
    # the return code is the Popen's the manager held
    if child.returncode is None or exits:
        raise AssertionError(f"the CLI child: return code "
                             f"{child.returncode}, exits {exits}")
    record = {"phase": "cli", "show_and_params_lines": shown,
              "show_and_params_s": show_s,
              "child": {"id": "cli", "pid": pid,
                        "return_code": child.returncode},
              "start_line": lines[0].strip(),
              "start_line_after_s": started_s,
              "card_free_memory_fall_gb": fall_gb,
              "card_total_gb": total / 1e9, "ran_s": ran_s}
    emit(record)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from aiko_services_tpu_torch.ops import kernels

    smi = nvidia_smi()
    print(smi, flush=True)
    start = time.perf_counter()
    built = kernels.build()
    build_s = time.perf_counter() - start
    # per kernel instantiation (its mangled name): registers, shared
    # memory and spills as ptxas reports them
    ptxas = {name: [line.strip().split("'")[1] if "entry function" in line
                    else line.split(":", 1)[-1].strip()
                    for line in text.splitlines()
                    if "entry function" in line or "registers" in line or
                    "spill" in line]
             for name, text in kernels.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "built": built,
          "ptxas": ptxas, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    device = torch.device("cuda")
    generator = torch.Generator(device=device).manual_seed(0)
    records = phase_kernels(device, generator)
    paged = phase_paged_kernel(generator)
    counts = phase_slice()
    pipeline_counts = phase_pipeline()
    remote_counts, remote_tokens = phase_remote_pipeline()
    peer_counts, peer_tokens = phase_peer_pipeline(remote_tokens)
    chaos_counts, _ = phase_peer_chaos(peer_tokens)
    phase_cli()
    phase_counts = {"slice": counts, "pipeline": pipeline_counts,
                    "remote_pipeline": remote_counts,
                    "peer_pipeline": peer_counts, "peer_chaos": chaos_counts}
    for record in records:
        record["launches"] = sum(phase_counts[phase][record["counter"]]
                                 for phase in record["counted_in"])
    # paged launches by (variant, path): the native decoder decodes, the
    # int8 one decodes with scales folded and extends dequantizing
    counts = {("paged_decode_attention", "decode"): phase_llama()}
    phase_llama_f32()
    int8_counts = phase_llama_int8_chunked()
    counts[("paged_decode_attention_int8_fold", "decode")] = \
        int8_counts["paged_decode_attention_int8_fold"]
    counts[("paged_decode_attention_int8_dequant", "extend")] = \
        int8_counts["paged_decode_attention_int8_dequant"]
    phase_llama_int8_f32()
    earlier = {phase: phase_counts[phase]["flash_attention"] for phase in
               ("slice", "pipeline", "remote_pipeline", "peer_pipeline",
                "peer_chaos")}
    earlier.update({
                    "llama": counts[("paged_decode_attention", "decode")],
                    "int8_fold":
                        int8_counts["paged_decode_attention_int8_fold"],
                    "int8_dequant":
                        int8_counts["paged_decode_attention_int8_dequant"]})
    if earlier != EARLIER_COUNTS:
        raise AssertionError(f"earlier phases' counts {earlier} != "
                             f"{EARLIER_COUNTS}")
    for record in paged:
        record["launches"] = counts.get((record["variant"], record["path"]),
                                        0)
    records += paged
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{key: record[key] for key in keys}
                      for record in records]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
