# A/B harness: the console comparison table is the product
# graft: disable-file=lint-print
# In-program A/B of a decoder option at the bench's Llama geometry: 1b in
# bf16, 256 slots, a closed loop.  The port's copy of tools/ab_w8.py, with
# its interface: AB_MODE picks the option under test against the plain
# decoder,
#   w8   — weight-only int8 (weight_quant=True);
#   fuse — fused qkv + gate_up projections (fuse_projections=True);
# AB_W8_WINDOW the closed loop's seconds a mode (20), AB_W8_PRESET the
# preset (1b).
#
# Prints tokens/s and the decoder's device step (serving
# .measure_device_step, ms a step of its own round program) per mode,
# then greedy-token parity between the modes on 32 fixed prompts, and
# where the outputs split, the teacher-forced logits of both weight
# forms there (tools/splits.py): whether the option's numerics alone
# turn the choice, and by how much the base run's choice led.
#
#   AB_MODE=w8 python -m aiko_services_tpu_torch.tools.ab_w8
#
# On the card only (the default device); the functions take device="cpu"
# and a smaller geometry for the tests.

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

__all__ = ["MODE_KWARGS", "build", "closed_loop", "greedy_runs", "parity",
           "split_witness", "run", "main"]

SLOTS = 256
MODE_KWARGS = {"w8": "weight_quant", "fuse": "fuse_projections"}


def build(params, config, option: str, enabled: bool, slots: int = SLOTS,
          steps_per_sync: int = 64, device=None):
    """The A/B's decoder: the option on or off."""
    from ..serving import ContinuousDecoder
    return ContinuousDecoder(params, config, max_slots=slots,
                             max_seq=1024, prefill_buckets=(128,),
                             steps_per_sync=steps_per_sync,
                             **{option: enabled},
                             name=f"{option}_{int(enabled)}", device=device)


def closed_loop(decoder, rng, window: float, new_tokens: int = 64,
                prompt_range=(16, 120)) -> float:
    """Tokens/s over `window` seconds of a closed loop that keeps 2 x
    slots requests queued (each finished request submits another), after
    a warm-up of two pumps and the bench's stats reset."""
    generated = [0]
    submitted = [0]
    deadline = [time.perf_counter() + 3600.0]

    def submit_one():
        prompt = rng.integers(
            1, decoder.config.vocab,
            size=int(rng.integers(*prompt_range))).tolist()
        request_id = f"r{submitted[0]}"
        submitted[0] += 1
        decoder.submit(request_id, prompt, new_tokens,
                       lambda rid, tokens: on_done(tokens))

    def on_done(tokens):
        generated[0] += len(tokens)
        if time.perf_counter() < deadline[0]:
            submit_one()

    for _ in range(2 * decoder.max_slots):      # warm-up: build + fill
        submit_one()
    decoder.pump()
    decoder.pump()        # the second round runs the decode scan
    # the bench's post-warm-up reset: warm-up must not reach the stats
    for key in decoder.stats:
        decoder.stats[key] = 0 if isinstance(decoder.stats[key], int) \
            else 0.0
    decoder.ttft_samples.clear()
    decoder.itl_samples.clear()
    decoder.gap_samples.clear()
    generated[0] = 0
    start = time.perf_counter()
    deadline[0] = start + window
    while time.perf_counter() < deadline[0] or not decoder.idle:
        decoder.pump()
    elapsed = time.perf_counter() - start
    return generated[0] / elapsed


def greedy_runs(params, config, option: str, n: int = 32,
                new_tokens: int = 32, slots: int = SLOTS,
                steps_per_sync: int = 64, device=None) -> tuple:
    """Greedy outputs of `n` fixed prompts (seed 7) with the option off
    and on: (prompts, {enabled: {index: tokens}})."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, config.vocab,
                            size=int(rng.integers(8, 100))).tolist()
               for _ in range(n)]
    outs = {}
    for enabled in (False, True):
        decoder = build(params, config, option, enabled, slots,
                        steps_per_sync, device)
        done = {}
        for i, prompt in enumerate(prompts):
            decoder.submit(f"p{i}", prompt, new_tokens,
                           lambda rid, toks, i=i: done.setdefault(i, toks))
        for _ in range(600):
            if len(done) == n:
                break
            decoder.pump()
        if len(done) != n:
            raise RuntimeError(f"only {len(done)}/{n} completed")
        outs[enabled] = done
        del decoder
    return prompts, outs


def parity(outs) -> float:
    """The fraction of greedy tokens equal between the option off and
    on, each output compared up to the shorter one."""
    total = match = 0
    for i in outs[False]:
        a, b = outs[False][i], outs[True][i]
        k = min(len(a), len(b))
        match += sum(x == y for x, y in zip(a[:k], b[:k]))
        total += k
    return match / max(total, 1)


def split_witness(params, config, option: str, prompts, outs,
                  device=None) -> dict:
    """tools/splits.py's witness at each output's first split: the
    teacher-forced logits (llama_forward) of the plain weights and of
    the option's serving form (weight_quant's int8 tree, or the fused
    projections) on the prompt and the shared tokens before the split."""
    from ..models import layers as L
    from ..models.llama import llama_forward
    from ..serving import _fuse_decode_projections
    from .splits import split_row, summary

    served = L.quantize_linear_tree(params) if option == "weight_quant" \
        else _fuse_decode_projections(params)
    rows = []
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            a, b = outs[False][i], outs[True][i]
            split = next((j for j, (x, y) in enumerate(zip(a, b))
                          if x != y), None)
            if split is None:
                continue
            tokens = torch.tensor([prompt + list(a[:split])],
                                  dtype=torch.long, device=device)
            base = llama_forward(params, config, tokens)[0, -1]
            other = llama_forward(served, config, tokens)[0, -1]
            rows.append(split_row(base, other, int(a[split]),
                                  int(b[split])))
    return summary(rows, len(prompts))


def run(mode: str = "w8", window: float = 20.0, preset: str = "1b",
        slots: int = SLOTS, steps_per_sync: int = 64, new_tokens: int = 64,
        prompts: int = 32, device=None) -> dict:
    """The A/B: tokens/s and the device step with the option off and on,
    then parity; prints a row each and returns them."""
    from .. import resolve_device
    from ..models.llama import LLAMA_PRESETS, llama_init
    from ..serving import measure_device_step
    from .splits import line

    option = MODE_KWARGS[mode]
    device = resolve_device(device)
    config = dataclasses.replace(LLAMA_PRESETS[preset],
                                 dtype=torch.bfloat16, max_seq_len=1024)
    params = llama_init(torch.Generator(device=device).manual_seed(0),
                        config, device=device)
    result = {}
    for enabled in (False, True):
        decoder = build(params, config, option, enabled, slots,
                        steps_per_sync, device)
        tps = closed_loop(decoder, np.random.default_rng(11), window,
                          new_tokens)
        step_ms = measure_device_step(decoder, steps_per_sync)
        result[enabled] = {"tokens_per_s": tps, "device_step_ms": step_ms}
        print(f"{option}={enabled}: {tps:,.0f} tok/s, device step "
              f"{step_ms:.2f} ms", flush=True)
        del decoder
        if device.type == "cuda":
            torch.cuda.empty_cache()
    fixed, outs = greedy_runs(params, config, option, n=prompts,
                              slots=slots, steps_per_sync=steps_per_sync,
                              device=device)
    result["parity"] = parity(outs)
    print(f"token parity ({prompts} fixed prompts, 32 tokens): "
          f"{result['parity']:.4f}", flush=True)
    result["splits"] = split_witness(params, config, option, fixed, outs,
                                     device)
    print(line(f"{option} splits", result["splits"]), flush=True)
    return result


def main(argv=None, device=None, environ=None) -> int:
    environ = os.environ if environ is None else environ
    run(mode=environ.get("AB_MODE", "w8"),
        window=float(environ.get("AB_W8_WINDOW", "20")),
        preset=environ.get("AB_W8_PRESET", "1b"), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
