# diagnostic harness: the console readout is the product
# graft: disable-file=lint-print
# The Whisper decode tail's read efficiency by the slope method: the
# port's copy of tools/diag_whisper_tail.py.
#
#   1. the decode tail's step time against n_audio_ctx at the bench
#      geometry (Whisper-small, bf16, batch 256, 24 tokens): greedy
#      decoding from audio features less a run that only projects the
#      cross K/V (precompute_cross_kv), over the 24 steps.  The slope's
#      bytes a frame are exact (K and V, every decoder layer, bf16), so
#      the slope is the effective cross-KV read rate; the intercept is
#      the fixed cost a step (the weights, ~170 small ops on [B, 1, 768]
#      activations, the self K/V).  The rate is set against the card's
#      measured ceiling (diag_membw.py, measured first in this run), not
#      a constant;
#   2. the fused program's ladder (mu-law expand, log-mel, encode,
#      greedy decode) at batch 256 and 512, unless --skip-512.
#
# Each program is timed as the repo tool times it: chains of 4 calls,
# the median of 5, the chain bracketed by CUDA events (timing.py).
#
#   python -m aiko_services_tpu_torch.tools.diag_whisper_tail [--skip-512]
#
# On the card only (the default device); the functions take device="cpu"
# and a smaller geometry for the tests.

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .diag_membw import SPEC_BYTES_PER_S, device_line
from .timing import timed_chain

__all__ = ["BATCH", "MAX_TOKENS", "CONTEXTS", "tail_config", "tail_step_ms",
           "cross_kv_bytes_per_frame", "fit", "ladder", "main"]

BATCH = 256
MAX_TOKENS = 24
CONTEXTS = (125, 250, 375, 500)


def tail_config(n_audio_ctx: int, preset: str = "small",
                max_tokens: int = MAX_TOKENS):
    from ..models.whisper import WHISPER_PRESETS
    return dataclasses.replace(
        WHISPER_PRESETS[preset], n_audio_ctx=n_audio_ctx,
        n_text_ctx=max_tokens + 8, dtype=torch.bfloat16)


def tail_step_ms(params, config, batch: int = BATCH,
                 max_tokens: int = MAX_TOKENS, device=None,
                 chain: int = 4, repeats: int = 5) -> float:
    """ms a decode step of the tail alone: greedy_decode_from_audio from
    zero audio features [batch, n_audio_ctx, dim] less the
    precompute_cross_kv run, over max_tokens."""
    from ..models.whisper import greedy_decode_from_audio, precompute_cross_kv

    device = torch.device(device)
    audio = torch.zeros((batch, config.n_audio_ctx, config.dim),
                        dtype=config.dtype, device=device)

    def tail():
        return greedy_decode_from_audio(params, config, audio,
                                        max_tokens=max_tokens)

    def kv_only():
        with torch.inference_mode():
            return precompute_cross_kv(params, config, audio)

    t_tail = timed_chain(tail, device, chain=chain, repeats=repeats)
    t_kv = timed_chain(kv_only, device, chain=chain, repeats=repeats)
    return (t_tail - t_kv) * 1000.0 / max_tokens


def cross_kv_bytes_per_frame(config, batch: int = BATCH) -> int:
    """K + V, every decoder layer, bf16: the bytes a step reads per
    audio frame."""
    return batch * config.dec_layers * 2 * config.dim * 2


def fit(contexts, steps_ms, bytes_per_frame: int) -> dict:
    """Least-squares slope (ms a frame) and intercept (ms a step), and
    the effective read rate the slope gives (GB/s)."""
    slope_ms, intercept_ms = np.polyfit(np.asarray(contexts, float),
                                        np.asarray(steps_ms, float), 1)
    gbps = bytes_per_frame / (slope_ms / 1000.0) / 1e9 if slope_ms > 0 \
        else float("inf")
    return {"slope_us_per_frame": float(slope_ms) * 1000.0,
            "intercept_ms": float(intercept_ms), "gbps": float(gbps)}


def ladder(params, config, batches=(256, 512),
           max_tokens: int = MAX_TOKENS, device=None, chain: int = 4,
           repeats: int = 5) -> dict:
    """The fused program's round time at each batch, and the
    device-resident streams it serves (batch x 5 s of audio over the
    round); a batch that fails ends the ladder."""
    from ..models.whisper import encode, greedy_decode_from_audio
    from ..ops.audio import WHISPER_HOP, log_mel_spectrogram, mulaw_decode

    device = torch.device(device)
    samples = config.n_audio_ctx * 2 * WHISPER_HOP
    generator = torch.Generator(device=device).manual_seed(2)
    results = {}
    for batch in batches:
        codes = torch.randint(0, 256, (batch, samples), generator=generator,
                              device=device, dtype=torch.int32).to(
                                  torch.uint8)

        def fused():
            with torch.inference_mode():
                mel = log_mel_spectrogram(mulaw_decode(codes),
                                          num_mels=config.n_mels)
                return greedy_decode_from_audio(
                    params, config, encode(params, config,
                                           mel.to(config.dtype)),
                    max_tokens=max_tokens)
        try:
            seconds = timed_chain(fused, device, chain=chain,
                                  repeats=repeats)
        except Exception as exc:
            print(f"batch {batch}: failed {exc!r}", flush=True)
            break
        results[batch] = {"round_ms": seconds * 1000.0,
                          "streams": batch * 5.0 / seconds}
        print(f"batch {batch}: round {seconds * 1000:.1f} ms -> "
              f"{batch * 5.0 / seconds:.0f} device-resident streams",
              flush=True)
        del codes
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def run(device=None, preset: str = "small", batch: int = BATCH,
        contexts=CONTEXTS, max_tokens: int = MAX_TOKENS,
        ladder_batches=(256, 512), ceiling_gbps=None, chain: int = 4,
        repeats: int = 5) -> dict:
    """The slope, its fit against the ceiling and (ladder_batches not
    empty) the ladder."""
    from .. import resolve_device
    from ..models.whisper import whisper_init
    from .diag_membw import measure

    device = resolve_device(device)
    if ceiling_gbps is None:
        ceiling_gbps = measure(device)["ceiling_gbps"]
    print(f"achievable-read reference: {ceiling_gbps:.1f} GB/s "
          f"(diag_membw.py, this run)", flush=True)
    params = whisper_init(torch.Generator(device=device).manual_seed(0),
                          tail_config(max(contexts), preset, max_tokens),
                          device=device)
    steps = []
    for ctx in contexts:
        config = tail_config(ctx, preset, max_tokens)
        ms = tail_step_ms(params, config, batch, max_tokens, device,
                          chain, repeats)
        steps.append(ms)
        print(f"n_audio_ctx {ctx}: tail step {ms:.3f} ms", flush=True)
    bytes_per_frame = cross_kv_bytes_per_frame(
        tail_config(contexts[0], preset, max_tokens), batch)
    result = fit(contexts, steps, bytes_per_frame)
    result.update(steps_ms=steps, ceiling_gbps=ceiling_gbps,
                  bytes_per_frame=bytes_per_frame)
    print(f"slope {result['slope_us_per_frame']:.3f} us/frame, intercept "
          f"{result['intercept_ms']:.3f} ms/step", flush=True)
    print(f"cross-KV bytes/frame {bytes_per_frame} -> effective read "
          f"bandwidth {result['gbps']:.1f} GB/s "
          f"({result['gbps'] / ceiling_gbps:.1%} of the measured ceiling, "
          f"{result['gbps'] * 1e9 / SPEC_BYTES_PER_S:.1%} of 3.35 TB/s)",
          flush=True)
    mid = contexts[len(contexts) // 2 - 1]
    print(f"fixed per-step cost {result['intercept_ms']:.3f} ms vs "
          f"cross-KV read at ctx {mid}: "
          f"{mid * result['slope_us_per_frame'] / 1000.0:.3f} ms",
          flush=True)
    if ladder_batches:
        result["ladder"] = ladder(
            params, tail_config(250 if 250 in contexts else contexts[0],
                                preset, max_tokens),
            ladder_batches, max_tokens, device, chain, repeats)
    return result


def main(argv=None, device=None) -> int:
    from .. import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    device = resolve_device(device)
    print(device_line(device), flush=True)
    run(device, ladder_batches=() if "--skip-512" in argv else (256, 512))
    return 0


if __name__ == "__main__":
    sys.exit(main())
