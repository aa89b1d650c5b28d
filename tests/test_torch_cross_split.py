"""The cross-decode kernel's split over T, in plain arithmetic on the CPU.

The CUDA kernel (csrc/cross_decode_attention.cu) cuts a call as
`cross_decode_plan` says: each block takes one run of positions of one
(batch, head) and keeps a partial (max, sum of weights, weighted sum of
values); a second kernel merges the partials of a (batch, head).  Here
the plain version's arithmetic is computed per split at the plan's
boundaries and merged with the kernel's formula; the result must be
cross_decode_attention_reference's in f32.  The plan itself must cover
[0, T) exactly once with no empty split."""

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.ops import attention as A

torch.set_num_threads(1)

H100_SMS = 132
HEAD_DIM = 16          # the plain arithmetic takes any head dim


def _case(seed, b, h, t):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, h, 1, HEAD_DIM), (b, h, t, HEAD_DIM),
                             (b, h, t, HEAD_DIM)))
    return q, k, v


def split_and_merge(q, k, v, split, splits, scale):
    """Per split: m = max score, l = sum 2^(s - m), acc = sum 2^(s - m) v
    (log2 domain, as the kernel); merged: sum 2^(m_s - M) acc_s /
    sum 2^(m_s - M) l_s."""
    t = k.shape[2]
    scores = torch.matmul(q.double(), k.double().transpose(-1, -2)) * \
        scale / np.log(2.0)                       # [B, H, 1, T], log2
    parts = []
    for sp in range(splits):
        lo, hi = sp * split, min((sp + 1) * split, t)
        s = scores[..., lo:hi]
        m = s.amax(dim=-1, keepdim=True)
        w = torch.exp2(s - m)
        parts.append((m, w.sum(dim=-1, keepdim=True),
                      torch.matmul(w, v[:, :, lo:hi].double())))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total = sum(torch.exp2(m - top) * l for m, l, _ in parts)
    acc = sum(torch.exp2(m - top) * a for m, _, a in parts)
    return (acc / total).float()


@pytest.mark.parametrize("b,h,t", [
    (8, 12, 1536),     # bucket 3072's cross K/V: 192-position splits
    (8, 12, 250),      # bucket 500's: 32-position splits, a ragged last
    (3, 5, 20000),     # a long T, few heads
    (1, 1, 1),         # one position, one split
    (2, 3, 65),        # one past a split boundary
    (3, 5, 4993),      # a last split of one position
])
def test_splits_merge_to_the_plain_version(b, h, t):
    q, k, v = _case(b * 1000 + t, b, h, t)
    split, splits = A.cross_decode_plan(b, h, t, H100_SMS)
    scale = HEAD_DIM ** -0.5
    merged = split_and_merge(q, k, v, split, splits, scale)
    expected = A.cross_decode_attention_reference(q, k, v, scale=scale)
    np.testing.assert_allclose(merged.numpy(), expected.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("b,h,t", [
    (8, 12, 1536), (8, 12, 250), (3, 5, 20000), (1, 1, 1), (3, 5, 7),
    (1, 1, 64), (1, 1, 65), (96, 1, 255), (1, 1, 257), (2, 2, 100000)])
def test_plan_covers_every_position_once(b, h, t):
    split, splits = A.cross_decode_plan(b, h, t, H100_SMS)
    assert split % 32 == 0
    runs = [(sp * split, min((sp + 1) * split, t)) for sp in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == t
    assert all(hi > lo for lo, hi in runs)                 # none empty
    assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))  # no gap


@pytest.mark.parametrize("b,h,t,plan", [
    # the decode tail's shapes on 132 SMs: one wave of 6 blocks an SM
    # holds 8 splits of each of the 96 (batch, head) pairs
    (8, 12, 1536, (192, 8)),
    (8, 12, 250, (32, 8)),
    # few heads, long T: 49 splits of 416 (52 would hold 385 each)
    (3, 5, 20000, (416, 49)),
    # more (batch, head) pairs than a wave holds: one split each
    (64, 12, 640, (640, 1)),
    # one position
    (1, 1, 1, (32, 1)),
])
def test_cross_decode_plan(b, h, t, plan):
    assert A.cross_decode_plan(b, h, t, H100_SMS) == plan
