"""Where two greedy runs split, and why: the A/B tools' witness for a
token match below 1.

At the first position where the base run and the option's run chose
different tokens after the same prefix, both programs' logits are taken
teacher-forced on that prefix.  The base logits give the margin of the
base token over the option's token, and the top-2 gap; the option's
logits give its own margin, and the shift it makes: its largest, and
its root mean square over the base logits' standard deviation.  A
split is *reproduced* when the option's logits rank the option's token
first of the two while the base logits rank the base token first: the
option's numerics alone turn the choice there.  A near-tie reads as a
base margin far under the logits' spread and under the option's shift;
a broken option path reads as a relative shift of the order of 1."""

from __future__ import annotations

import statistics

import torch

__all__ = ["split_row", "summary", "line"]


def split_row(base_logits, option_logits, base_token: int,
              option_token: int) -> dict:
    """The witness at one split: logits [vocab] of both programs on the
    shared prefix, and the two tokens chosen there."""
    base = base_logits.float()
    option = option_logits.float()
    top = torch.topk(base, 2).values
    return {"base_margin": float(base[base_token] - base[option_token]),
            "option_margin": float(option[option_token] -
                                   option[base_token]),
            "top2_gap": float(top[0] - top[1]),
            "shift": float((option - base).abs().max()),
            "relative_shift": float((option - base).pow(2).mean().sqrt() /
                                    base.std()),
            "spread": float(base.std())}


def summary(rows: list, compared: int) -> dict:
    """The splits of `compared` sequences: how many, how many the
    teacher-forced logits reproduce, and the medians of each row
    field."""
    out = {"compared": compared, "splits": len(rows),
           "reproduced": sum(row["base_margin"] >= 0.0 and
                             row["option_margin"] >= 0.0 for row in rows)}
    for key in ("base_margin", "top2_gap", "shift", "relative_shift",
                "spread"):
        out[f"{key}_median"] = statistics.median(
            row[key] for row in rows) if rows else None
    return out


def line(label: str, witness: dict) -> str:
    """One printed row of the witness."""
    if not witness["splits"]:
        return f"{label}: no split in {witness['compared']} sequences"
    return (f"{label}: {witness['splits']} of {witness['compared']} "
            f"sequences split, {witness['reproduced']} reproduced "
            f"teacher-forced; at the split, median base margin "
            f"{witness['base_margin_median']:.4g}, top-2 gap "
            f"{witness['top2_gap_median']:.4g}, option's logit shift "
            f"{witness['shift_median']:.4g} at most and "
            f"{witness['relative_shift_median']:.4g} of the logits' std "
            f"({witness['spread_median']:.4g}) in rms")
