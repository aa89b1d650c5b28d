# Plain full attention: the dispatcher's short-sequence path.
#
# Counterpart of aiko_services_tpu/parallel/ring_attention.py's
# attention_reference.  Ring attention itself is not ported yet.

from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal: bool = False,
                        scale: float | None = None):
    """Plain full attention with f32 scores and softmax.
    q: [B, H, Sq, D], k/v: [B, H, Sk, D] → [B, H, Sq, D] in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(k_pos > q_pos, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)
