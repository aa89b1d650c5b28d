"""The paged kernel's split over T, in plain arithmetic on the CPU.

The CUDA kernel (csrc/paged_decode_attention.cu) cuts a call as
`kernel_plan` says: on the split path each block covers a run of main
positions of one (slot, KV head, row tile), or the side buffer, and
keeps a partial (max, sum of weights, weighted sum of values); a second
kernel merges the partials of a row.  Here the plain version is computed
per split at the plan's boundaries, with the kernel's rules for what a
block covers (a split past the slot's extent contributes nothing unless
a row of its tile sees nothing at all), and merged with the kernel's
formula; the result must be paged_decode_attention_reference's in f32,
in the three numerics (native, int8 folded, int8 dequantized)."""

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models.layers import (dequantize_kv_cache,
                                                   gather_paged_kv,
                                                   quantize_kv_cache)
from aiko_services_tpu_torch.ops import paged_attention as P

torch.set_num_threads(1)

H100_SMS = 132
HEAD_DIM = 16          # the plain arithmetic takes any head dim
SCALE = 0.25


def _case(seed, groups, width, block, nb, entries, side_len):
    """Operands (f32 pools) with slot 0 at extent 0; its query 0 sees no
    side entry either (a fully masked row), its other queries some."""
    rng = np.random.default_rng(seed)
    slots, num_kv = len(entries), 2
    num_blocks = slots * nb + 1
    pools = [torch.from_numpy(rng.standard_normal(
        (num_blocks, num_kv, block, HEAD_DIM)).astype(np.float32))
        for _ in range(2)]
    for pool in pools:
        pool[0] = 0                                 # the null block
    ids = rng.permutation(np.arange(1, num_blocks))
    tables = np.zeros((slots, nb), np.int32)
    for s, entry in enumerate(entries):
        used = -(-entry // block)
        tables[s, :used] = ids[s * nb:s * nb + used]
    q = torch.from_numpy(rng.standard_normal(
        (slots, num_kv, groups * width, HEAD_DIM)).astype(np.float32))
    sides = [torch.from_numpy(rng.standard_normal(
        (slots, num_kv, side_len, HEAD_DIM)).astype(np.float32))
        for _ in range(2)]
    side_valid = rng.random((slots, width, side_len)) < 0.5
    side_valid[:, :, 0] = True
    side_valid[0, 0] = False
    return (q, pools[0], pools[1], torch.from_numpy(tables), sides[0],
            sides[1], torch.from_numpy(side_valid),
            torch.tensor(entries, dtype=torch.int32))


def _quantized(pool):
    leaf = quantize_kv_cache(pool)
    leaf["s"][0] = 0
    return leaf


def _partial(scores, values):
    """(max, sum of weights, weights . values) of scores [H, R, n] over
    values [H, n, D]; values carry the fold's s_v already when folding."""
    top = scores.max(dim=-1).values
    weights = torch.exp(scores - top[..., None])
    return top, weights.sum(dim=-1), weights, values


def split_and_merge(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                    entry_lengths, *, groups, fold, plan):
    """The plain version computed split by split as the kernel's split
    path cuts it, then merged: out = sum_s e^(m_s - M) acc_s /
    sum_s e^(m_s - M) l_s over the splits that covered anything."""
    path, tile_rows, split, main_splits = plan
    assert path == P.SPLIT_PATH
    slots_n, _, rows, _ = q.shape
    width = rows // groups
    k_main, v_main = gather_paged_kv(k_pool, tables), \
        gather_paged_kv(v_pool, tables)
    k_fold = v_fold = None
    if isinstance(k_main, dict) and fold:
        k_fold, v_fold = k_main["s"], v_main["s"]        # [S, H, T]
        k_main, v_main = k_main["q"].float(), v_main["q"].float()
    else:
        k_main = dequantize_kv_cache(k_main, q.dtype).float()
        v_main = dequantize_kv_cache(v_main, q.dtype).float()
    covered = k_main.shape[2]
    assert main_splits == -(-covered // split)
    scores_main = torch.matmul(q, k_main.transpose(-1, -2)) * SCALE
    if k_fold is not None:
        scores_main = scores_main * k_fold[:, :, None]
    scores_side = torch.matmul(q, k_side.transpose(-1, -2)) * SCALE
    row_w = torch.arange(rows) % width
    out = torch.empty(q.shape)
    for s in range(slots_n):
        entry = int(entry_lengths[s])
        main_ok = torch.arange(covered) < entry
        main = torch.where(main_ok, scores_main[s], torch.tensor(-1e30))
        side = torch.where(side_valid[s][row_w][None], scores_side[s],
                           torch.tensor(-1e30))
        values = v_main[s] if v_fold is None else \
            v_main[s] * v_fold[s][..., None]
        for row0 in range(0, rows, tile_rows):
            tile = slice(row0, min(rows, row0 + tile_rows))
            sees_nothing = entry <= 0 and not bool(
                side_valid[s][row_w[tile]].any(dim=-1).all())
            limit = covered if sees_nothing else min(max(entry, 0), covered)
            parts = []
            for sp in range(main_splits):
                lo, hi = sp * split, min((sp + 1) * split, limit)
                if lo < hi:
                    parts.append(_partial(main[:, tile, lo:hi],
                                          values[:, lo:hi]))
            if k_side.shape[2]:
                parts.append(_partial(side[:, tile], v_side[s]))
            top = torch.stack([m for m, *_ in parts]).max(dim=0).values
            total = sum(torch.exp(m - top) * l for m, l, *_ in parts)
            acc = sum(torch.exp(m - top)[..., None] * torch.matmul(w, v)
                      for m, _, w, v in parts)
            out[s, :, tile] = acc / total[..., None]
    return out


NUMERICS = ["native", "int8_fold", "int8_dequant"]


def _operands(numerics, case):
    operands = list(case)
    if numerics != "native":
        operands[1], operands[2] = (_quantized(pool)
                                    for pool in operands[1:3])
    return operands, numerics == "int8_fold"


@pytest.mark.parametrize("numerics", NUMERICS)
@pytest.mark.parametrize("groups,width,entries", [
    # the decode shape's 4 rows: extents on, and either side of, the
    # 64-position split boundary, one split, the whole table
    (4, 1, [0, 63, 64, 65, 128, 250, 256]),
    # 12 rows in one 16-row tile, a partly masked side buffer
    (4, 3, [0, 1, 100, 256]),
    # 40 rows in three tiles: only the first holds the fully masked row
    (2, 20, [0, 31, 192]),
])
def test_splits_merge_to_the_plain_version(numerics, groups, width,
                                           entries):
    block, nb = 16, 16                            # 256 positions
    operands, fold = _operands(numerics, _case(
        len(entries) * 7 + width, groups, width, block, nb, entries, 5))
    plan = P.kernel_plan(False, len(entries), 2, groups * width,
                         block * nb, H100_SMS)
    assert plan[0] == P.SPLIT_PATH and plan[2] == 64 and plan[3] == 4
    expected = P.paged_decode_attention_reference(
        *operands, groups=groups, scale=SCALE, fold_scales=fold)
    merged = split_and_merge(*operands, groups=groups, fold=fold,
                             plan=plan)
    np.testing.assert_allclose(merged.numpy(), expected.numpy(), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("numerics", NUMERICS)
def test_fully_masked_row_spans_every_split(numerics):
    """Slot 0's query 0 sees nothing: it averages all 256 main and 5 side
    values uniformly, which the merge gives only when every split of its
    tile covers its positions."""
    operands, fold = _operands(numerics, _case(11, 4, 1, 16, 16, [0, 40],
                                               5))
    plan = P.kernel_plan(False, 2, 2, 4, 256, H100_SMS)
    merged = split_and_merge(*operands, groups=4, fold=fold, plan=plan)
    expected = P.paged_decode_attention_reference(
        *operands, groups=4, scale=SCALE, fold_scales=fold)
    np.testing.assert_allclose(merged[0, :, 0].numpy(),
                               expected[0, :, 0].numpy(), rtol=0, atol=2e-6)
    v_main = gather_paged_kv(operands[2], operands[3])
    v_main = (v_main["q"].float() * v_main["s"][..., None]) \
        if isinstance(v_main, dict) and fold \
        else dequantize_kv_cache(v_main, torch.float32).float()
    uniform = torch.cat([v_main[0], operands[5][0]], dim=1).mean(dim=1)
    np.testing.assert_allclose(merged[0, :, 0].numpy(), uniform.numpy(),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("is_bf16,slots,rows,positions,plan", [
    # the Llama-1B decode rows (16 slots, 8 KV heads, 4 rows), t_cap 256
    # and 512: 64- and 128-position splits, 4 main splits each
    (True, 16, 4, 256, (P.SPLIT_PATH, 4, 64, 4)),
    (True, 16, 4, 512, (P.SPLIT_PATH, 4, 128, 4)),
    # 40 slots at t_cap 1024: splits grow to the 256-position cap
    (True, 40, 4, 1024, (P.SPLIT_PATH, 4, 256, 4)),
    # the path cut: 16 bf16 rows split over T, 17 take the tensor cores
    (True, 16, 16, 256, (P.SPLIT_PATH, 16, 64, 4)),
    (True, 16, 17, 256, (P.TENSOR_PATH, 256, 256, 1)),
    # the chunk extend (256 rows): tensor cores in bf16, split in f32
    (True, 16, 256, 768, (P.TENSOR_PATH, 256, 768, 1)),
    (False, 4, 256, 1024, (P.SPLIT_PATH, 16, 256, 4)),
    # a table whose positions are not a multiple of the split
    (False, 3, 12, 40, (P.SPLIT_PATH, 16, 64, 1)),
])
def test_kernel_plan(is_bf16, slots, rows, positions, plan):
    assert P.kernel_plan(is_bf16, slots, 8, rows, positions,
                         H100_SMS) == plan
