# experiment harness: the console readout is the product
# graft: disable-file=lint-print
# The vocoder data-scaling sweep on the port: the port's copy of
# tools/train_vocoder_scale.py.  The vocoder's training data is the
# synthetic tone language (tests/torch_golden.py), so more of it is
# free: widening the corpus from 8 to 29 utterances (every 1-3-word
# sequence without the held-out adjacency) at the same geometry is the
# recipe the repo's vocoder gate trains (tests/test_tts.py
# train_vocoder), and bigger geometries on the wide corpus were the
# sweep's other arms.  This tool re-runs the sweep by calling the port's
# copy of that trainer (tests/torch_golden.py train_vocoder) with the
# same corpus / geometry overrides, so the recipe and the experiment
# cannot drift, and reports each run's held-out copy-synthesis MCD
# (ops/audio.py mel_cepstral_distortion) beside Griffin-Lim's at 16 and
# 32 rounds on the same held-out text.
#
# Runs (--runs picks them by name, in this order; default all):
#   base8    8 utterances, channels (96, 48, 24), basis 64, 6000 steps,
#            window 64
#   wide     the canonical recipe: 29 utterances, (96, 48, 24), basis
#            64, 9000 steps, window 96
#   wide128  29 utterances, (128, 64, 32), basis 64
#   wide192  29 utterances, (192, 96, 48), basis 96
#
#   python -m aiko_services_tpu_torch.tools.train_vocoder_scale \
#       [--runs wide[,base8,...]]
#
# On the card (the default device): 9,000 eager steps take minutes
# there and hours on the CPU.

from __future__ import annotations

import argparse
import os
import sys
import time

__all__ = ["HELD_OUT", "RUNS", "golden", "runs", "run", "main"]

HELD_OUT = ["alpha", "charlie"]
# name: (corpus, channels, basis, steps, window)
RUNS = {
    "base8": ("base", (96, 48, 24), 64, 6000, 64),
    "wide": ("wide", (96, 48, 24), 64, 9000, 96),
    "wide128": ("wide", (128, 64, 32), 64, 9000, 96),
    "wide192": ("wide", (192, 96, 48), 96, 9000, 96),
}


def golden():
    """tests/torch_golden.py, from the tests folder of the checkout that
    holds this package."""
    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_golden
    return torch_golden


def runs(names=None) -> list:
    """(name, texts, VocoderConfig, steps, window) for each named run."""
    from ..models.vocoder import VocoderConfig

    corpus = golden()
    texts = {"base": [t for t in corpus.TEXTS if t != HELD_OUT],
             "wide": corpus.vocoder_corpus(HELD_OUT)}
    names = list(RUNS) if not names else list(names)
    unknown = [name for name in names if name not in RUNS]
    if unknown:
        raise ValueError(f"unknown runs {unknown}: choose from "
                         f"{sorted(RUNS)}")
    return [(name, texts[RUNS[name][0]],
             VocoderConfig(channels=RUNS[name][1], basis=RUNS[name][2]),
             RUNS[name][3], RUNS[name][4]) for name in names]


def run(names=None, device=None, gl_rounds=(16, 32)) -> dict:
    """Train each named run; {name: {"utterances", "channels", "basis",
    "steps", "loss", "train_s", "s_per_step", "mcd"}} and, under "gl",
    Griffin-Lim's held-out MCD at each of gl_rounds."""
    from .. import resolve_device

    device = resolve_device(device)
    corpus = golden()
    results = {"gl": {n: corpus.griffin_lim_mcd(n, HELD_OUT, device)
                      for n in gl_rounds}}
    for name, texts, config, steps, window in runs(names):
        start = time.perf_counter()
        stats = {}
        params, config = corpus.train_vocoder(
            HELD_OUT, vocoder_config=config, texts=texts, steps=steps,
            window=window, device=device, stats=stats)
        mcd = corpus.held_out_mcd(params, config, HELD_OUT, device)
        results[name] = {"utterances": len(texts),
                         "channels": config.channels, "basis": config.basis,
                         "steps": steps, "loss": stats["loss"],
                         "train_s": stats["seconds"],
                         "s_per_step": stats["seconds"] / steps, "mcd": mcd}
        print(f"{name:8s} ({len(texts):2d} utts) channels={config.channels}"
              f" basis={config.basis} steps={steps} loss="
              f"{stats['loss']:.5f} held-out MCD={mcd:.2f} dB "
              f"({time.perf_counter() - start:.0f}s, "
              f"{stats['seconds'] / steps * 1e3:.2f} ms/step)", flush=True)
    print("Griffin-Lim on the same held-out text: " + "; ".join(
        f"GL-{n} {mcd:.2f} dB" for n, mcd in results["gl"].items()),
        flush=True)
    return results


def main(argv=None, device=None) -> int:
    from .. import resolve_device
    from .diag_membw import device_line

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--runs", default="",
                        help="comma-separated run names (default all)")
    args = parser.parse_args(argv)
    device = resolve_device(device)
    print(device_line(device), flush=True)
    names = [name for name in args.runs.split(",") if name] or None
    run(names, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
