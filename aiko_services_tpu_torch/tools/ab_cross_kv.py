# A/B harness: the console comparison table is the product
# graft: disable-file=lint-print
# In-program A/B of Whisper's cross-KV modes at the bench's geometry
# (whisper-small bf16, batch 256, 5 s chunks, 24 tokens): bf16 against
# int8 per position and int8 per tensor (the scalar scale folded into the
# softmax scale).  The port's copy of tools/ab_cross_kv.py: the timed
# program is the ASR element's fused one (mu-law decode, log-mel, encode,
# greedy decode with its cross-KV mode), run eagerly on the card.
#
# Prints the round time and the device-resident streams per mode (batch x
# 5 s of audio over the round time), then each int8 mode's greedy-token
# match against the bf16 program, masked by the decoded lengths, and
# where a row splits from the bf16 one, both cross-KV forms' logits
# there, teacher-forced on the shared tokens (tools/splits.py).
#
#   python -m aiko_services_tpu_torch.tools.ab_cross_kv
#
# On the card only (the default device); run() takes device="cpu" and a
# smaller geometry for the tests.

from __future__ import annotations

import dataclasses
import sys

import torch

from .timing import timed_chain

__all__ = ["MODES", "run", "split_witness", "main"]

BATCH = 256
MAX_TOKENS = 24
MODES = (False, "position", "tensor")


def run(preset: str = "small", batch: int = BATCH,
        max_tokens: int = MAX_TOKENS, n_audio_ctx: int = 250,
        chain: int = 4, repeats: int = 5, device=None,
        modes=MODES) -> dict:
    """Each mode's (seconds a round, tokens, lengths), timed as the
    repo tool times it (chains of 4 rounds, median of 5), printing a row
    a mode and then each int8 mode's token match and split witness;
    returns {mode: (seconds, tokens [B, T], lengths [B])} and, under
    "splits", {int8 mode: split_witness's summary}."""
    from .. import resolve_device
    from ..models.whisper import (WHISPER_PRESETS, encode,
                                  greedy_decode_from_audio, whisper_init)
    from ..ops.audio import WHISPER_HOP, log_mel_spectrogram, mulaw_decode
    from .splits import line

    device = resolve_device(device)
    config = dataclasses.replace(
        WHISPER_PRESETS[preset], n_audio_ctx=n_audio_ctx,
        n_text_ctx=max_tokens + 8, dtype=torch.bfloat16)
    params = whisper_init(torch.Generator(device=device).manual_seed(0),
                          config, device=device)
    samples = config.n_audio_ctx * 2 * WHISPER_HOP
    codes = torch.randint(
        0, 256, (batch, samples),
        generator=torch.Generator(device=device).manual_seed(2),
        device=device, dtype=torch.int32).to(torch.uint8)

    def fused(mode):
        @torch.inference_mode()
        def program():
            audio = mulaw_decode(codes)
            mel = log_mel_spectrogram(audio, num_mels=config.n_mels)
            return greedy_decode_from_audio(
                params, config, encode(params, config, mel.to(config.dtype)),
                max_tokens=max_tokens, kv_quant=mode)
        return program

    results = {"splits": {}}
    for mode in modes:
        program = fused(mode)
        seconds = timed_chain(program, device, chain=chain,
                              repeats=repeats)
        tokens, lengths = program()[:2]
        results[mode] = (seconds, tokens.cpu(), lengths.cpu())
        streams = batch * 5.0 / seconds
        print(f"mode {str(mode):8s}: round {seconds * 1e3:7.1f} ms -> "
              f"{streams:6.0f} streams", flush=True)

    # mask by decoded lengths, as the bench A/B does: post-EOS padding
    # would otherwise inflate the match rate
    if False in results:
        _, base, base_len = results[False]
        with torch.inference_mode():
            audio = encode(params, config, log_mel_spectrogram(
                mulaw_decode(codes), num_mels=config.n_mels).to(
                    config.dtype))
        for mode in modes:
            if mode is False:
                continue
            seconds, tokens, lengths = results[mode]
            valid = torch.arange(base.shape[1])[None, :] < \
                torch.minimum(base_len, lengths)[:, None]
            match = (tokens == base)[valid].float().mean().item() \
                if valid.any() else 1.0
            delta = seconds / results[False][0] - 1.0
            print(f"mode {mode:8s}: token match {match:.4f}, "
                  f"round delta {delta:+.1%}", flush=True)
            results["splits"][mode] = split_witness(
                params, config, audio, base, tokens, valid, mode)
            print(line(f"mode {mode:8s} splits", results["splits"][mode]),
                  flush=True)
    return results


@torch.inference_mode()
def split_witness(params, config, audio, base, tokens, valid,
                  mode) -> dict:
    """tools/splits.py's witness at each row's first split from the bf16
    run (within `valid`): decode_step's logits, teacher-forced on the
    start token and the bf16 run's tokens, over the bf16 cross K/V and
    over `mode`'s int8 ones."""
    from ..models.whisper import decode_step, init_caches, \
        precompute_cross_kv
    from .splits import split_row, summary

    batch, width = base.shape
    device = audio.device
    prompt = torch.cat([torch.full((batch, 1), config.sot,
                                   dtype=torch.long),
                        base[:, :width - 1].long()], dim=1).to(device)
    logits = {}
    for quantize in (False, mode):
        cross_kv = precompute_cross_kv(params, config, audio,
                                       quantize=quantize)
        caches = init_caches(config, batch, max_len=width, device=device)
        # position t of the prompt predicts emitted token t
        logits[quantize] = decode_step(params, config, prompt, cross_kv,
                                       caches)[0]
    differs = (tokens != base) & valid
    rows = []
    for row in torch.nonzero(differs.any(dim=1)).flatten().tolist():
        split = int(torch.nonzero(differs[row]).min())
        rows.append(split_row(logits[False][row, split],
                              logits[mode][row, split],
                              int(base[row, split]),
                              int(tokens[row, split])))
    return summary(rows, batch)


def main(argv=None, device=None) -> int:
    run(device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
