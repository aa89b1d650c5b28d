"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one.  On the
card, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(--noconftest: tests/conftest.py imports jax, which the port's machine
need not have; nothing here imports jax.)  Shapes cover the edges the
main path does not reach: one head, ragged batch x heads, causal tiles,
strided layouts, T = 1, T not a multiple of 8, and a T whose scores
need more than 48 KB of shared memory; for the paged kernel, its three
numerics (native, int8 folded, int8 dequantized) on both of its paths
(split over T; tensor cores for more than 16 bf16 rows per KV head),
extents around split boundaries, fully masked rows, B not a power of
two, and more blocks than multiprocessors; the paged kernel again at
head dim 128 (Llama-3-8B), every numerics on both paths, at the 8B
decode shape and a TP-8 rank's (one KV head)."""

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

# The kernel's bf16 output against its plain version in f32 on the same
# input values, elementwise (x = sum_j p_j v_j / l):
#   |kernel - plain| <= U * |plain| + c * sum_j p_j |v_j| / l
# with U = 2^-8 (bf16 unit roundoff: the output's rounding) and c the
# kernel's own rounding (flash: bf16 probabilities, c = U; cross-decode:
# f32 throughout, c = 2^-12); and the relative L2 error of the whole
# output under a limit about 2.5x what rounding alone gives.  The same
# model as chip_smoke.py's.
U = 2 ** -8
FLASH = (U, 0.008)
CROSS = (2 ** -12, 0.004)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(generator, *shape):
    return torch.randn(*shape, generator=generator, device="cuda",
                       dtype=torch.float32).to(torch.bfloat16)


def _assert_close(out, plain, q, k, v, tolerance):
    """plain(q, k, v) is the kernel's plain version."""
    c, rel_l2_limit = tolerance
    q, k, v = q.float(), k.float(), v.float()
    ref, magnitude = plain(q, k, v), plain(q, k, v.abs())
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - ref).abs()
    excess = err - (U * ref.abs() + c * magnitude)
    assert excess.max().item() <= 0, err.max().item()
    assert (err.norm() / ref.norm()).item() <= rel_l2_limit


@pytest.mark.parametrize("layout", ["contiguous", "heads_last"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s", [(1, 1, 64), (2, 3, 128), (3, 5, 640),
                                   (2, 2, 192), (2, 12, 1536)])
def test_flash_kernel_matches_plain(card, b, h, s, causal, layout):
    """The kernel takes 192 query rows and 128 keys a tile: at S = 64,
    128 and 640 the last Q tile reaches past S, at 64, 192 and 640 the
    last key tile is half a tile (S not a multiple of 128: the wrapper
    then takes 64-row blocks, as the Pallas kernel's contract asks); 1536
    is the encoder's context at bucket 3072."""
    generator = torch.Generator(device=card).manual_seed(b * 100 + s)
    if layout == "contiguous":
        q, k, v = (_randn(generator, b, h, s, 64) for _ in range(3))
    else:   # [B, S, H, D] buffers viewed as heads, as layers.mha passes
        q, k, v = (_randn(generator, b, s, h, 64).permute(0, 2, 1, 3)
                   for _ in range(3))
    blocks = 128 if s % 128 == 0 else 64
    before = A.launches["flash_attention"]
    out = A.flash_attention(q, k, v, causal=causal, block_q=blocks,
                            block_k=blocks)
    assert A.launches["flash_attention"] == before + 1
    assert out.shape == (b, h, s, 64) and out.dtype == torch.bfloat16
    _assert_close(out, lambda *x: A.flash_attention_reference(
        *x, causal=causal), q, k, v, FLASH)


def test_flash_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 128, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        A.flash_attention(q.float(), q.float(), q.float())
    narrow = torch.zeros((1, 2, 128, 32), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(narrow, narrow, narrow)
    ragged = torch.zeros((1, 2, 96, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64-row tile"):
        A.flash_attention(ragged, ragged, ragged)
    strided = torch.zeros((1, 2, 128, 128), device=card,
                          dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        A.flash_attention(strided, q, q)
    with pytest.raises(ValueError, match="positive scale"):
        A.flash_attention(q, q, q, scale=-0.125)


def test_flash_kernel_persistent_grid_walks_more_tiles_than_blocks(card):
    """More (batch*head, 192-row) tiles than multiprocessors: each block
    of the persistent grid takes several, its ring running across them."""
    generator = torch.Generator(device=card).manual_seed(7)
    b, h, s = 4, 40, 256                     # 320 tiles, 132 blocks
    q, k, v = (_randn(generator, b, h, s, 64) for _ in range(3))
    out = A.flash_attention(q, k, v)
    _assert_close(out, A.flash_attention_reference, q, k, v, FLASH)


@pytest.mark.parametrize("t", [1, 7, 63, 64, 65, 127, 129, 200, 250, 1536,
                               1664, 1665, 4991, 4992, 4993, 9215, 9216,
                               9217, 20000])
def test_cross_decode_kernel_matches_plain(card, t):
    """At B = 3, H = 5 the plan (on 132 SMs) cuts T into up to 52 splits
    of a multiple of 32 positions: 32 up to T = 1664 (52 x 32), 96 up to
    4992, 192 at 9216 (48 x 192); T on and either side of such
    boundaries, where the last split holds 1 position or a whole split
    or one less."""
    generator = torch.Generator(device=card).manual_seed(t)
    b, h = 3, 5
    q = _randn(generator, b, 1, h * 64).view(b, 1, h, 64).permute(0, 2, 1, 3)
    k, v = (_randn(generator, b, t, h * 64).view(b, t, h, 64)
            .permute(0, 2, 1, 3) for _ in range(2))
    before = A.launches["cross_decode_attention"]
    out = A.cross_decode_attention(q, k, v)
    assert A.launches["cross_decode_attention"] == before + 1
    assert out.shape == (b, h, 1, 64)
    _assert_close(out, A.cross_decode_attention_reference, q, k, v, CROSS)


# -- paged decode attention ---------------------------------------------------
# The kernel writes f32 and is held against its plain version run in f32
# on the same input values.  The split path (f32, and bf16 with at most
# 16 rows per KV head) keeps f32 throughout: elementwise
# |kernel - plain| <= 2^-12 * sum_j p_j |v_j| / l (f32 sums in another
# order, exp2 with the scale folded into the query, splits merged;
# thousands of times the f32 rounding), and a relative L2 error under
# 1e-4 — one key dropped or mis-weighted in a row of T <= 1024 moves that
# row by ~1/sqrt(T).  The tensor-core path (bf16, more than 16 rows)
# rounds each unnormalised probability to bf16 for the PV product, as
# flash does (and as JAX and the plain version round their weights to
# the compute type): a relative error of at most 2^-8, bf16's unit
# roundoff, per weight, so c = 2^-8 as flash's, and a relative L2 limit
# of 0.003, about 2.5x what that rounding alone gives (relative errors
# spread over [-2^-8, 2^-8]: ~0.0012 rms).
PAGED = (2 ** -12, 1e-4)
PAGED_TENSOR_CORES = (2 ** -8, 0.003)


def _paged_tolerance(q):
    """The tolerance of the path kernel_plan gives q's shape and type."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    slots, num_kv, rows, _ = q.shape
    path = P.kernel_plan(q.dtype == torch.bfloat16, slots, num_kv, rows, 1,
                         1)[0]
    return PAGED_TENSOR_CORES if path == P.TENSOR_PATH else PAGED


def _paged_case(generator, dtype, slots, num_kv, groups, width, block, nb,
                side_len, entries, head_dim=64):
    """Pool, tables and side buffer of one case; entries[s] is slot s's
    extent (0 on slot 0 also masks its query row 0 completely)."""
    num_blocks = slots * nb + 3
    shape = (num_blocks, num_kv, block, head_dim)
    k_pool, v_pool = (torch.randn(shape, generator=generator, device="cuda")
                      .to(dtype) for _ in range(2))
    k_pool[0] = 0
    v_pool[0] = 0
    ids = torch.randperm(num_blocks - 1, generator=generator,
                         device="cuda") + 1
    tables = torch.zeros((slots, nb), dtype=torch.int32, device="cuda")
    for s, entry in enumerate(entries):
        used = -(-entry // block)
        tables[s, :used] = ids[s * nb:s * nb + used].to(torch.int32)
    q = torch.randn((slots, num_kv, groups * width, head_dim),
                    generator=generator, device="cuda").to(dtype)
    k_side, v_side = (torch.randn((slots, num_kv, side_len, head_dim),
                                  generator=generator, device="cuda")
                      .to(dtype) for _ in range(2))
    side_valid = torch.rand((slots, width, side_len), generator=generator,
                            device="cuda") < 0.6
    side_valid[:, :, 0] = True
    if entries[0] == 0:
        side_valid[0, 0] = False
    entry = torch.tensor(entries, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, tables, k_side, v_side, side_valid, entry


def _assert_paged_close(out, operands, groups):
    from aiko_services_tpu_torch.ops.paged_attention import \
        paged_decode_attention_reference as plain
    c, rel_l2_limit = _paged_tolerance(operands[0])
    q, k_pool, v_pool, tables, k_side, v_side, side_valid, entry = operands
    # int8 pools ({"q", "s"}) stay as they are: the plain version takes
    # their values exactly in f32, the scales folded
    f32 = [x if isinstance(x, dict) else x.float()
           for x in (q, k_pool, v_pool, k_side, v_side)]
    v_abs = dict(f32[2], q=f32[2]["q"].abs()) if isinstance(f32[2], dict) \
        else f32[2].abs()
    # the wrapper's default, f32(1) / sqrt(f32(D)): 0.125 at D = 64
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    ref = plain(f32[0], f32[1], f32[2], tables, f32[3], f32[4], side_valid,
                entry, groups=groups, scale=scale)
    magnitude = plain(f32[0], f32[1], v_abs, tables, f32[3],
                      f32[4].abs(), side_valid, entry, groups=groups,
                      scale=scale)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    err = (out - ref).abs()
    assert (err - c * magnitude).max().item() <= 0, err.max().item()
    assert (err.norm() / ref.norm()).item() <= rel_l2_limit


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("groups,width,block", [
    (4, 1, 32), (1, 1, 8), (2, 3, 16), (4, 3, 8)])
def test_paged_kernel_edges_match_plain(card, dtype, groups, width, block):
    """Extents 0 (one row fully masked), a multiple of the block, one
    ending inside a block; table entries past the extent on the null
    block; a partial side mask."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    generator = torch.Generator(device=card).manual_seed(groups * 31 + block)
    nb = 4
    entries = [0, 2 * block, block + 3, nb * block]
    operands = _paged_case(generator, getattr(torch, dtype), 4, 2, groups,
                           width, block, nb, 5, entries)
    before = P.launches["paged_decode_attention"]
    out = P.paged_decode_attention(*operands, groups=groups)
    assert P.launches["paged_decode_attention"] == before + 1
    assert out.shape == (4, 2, groups * width, 64)
    _assert_paged_close(out, operands, groups)


@pytest.mark.parametrize("slots,t_cap", [(2, 1024), (16, 256), (24, 512),
                                         (40, 1024)])
def test_paged_kernel_decode_shapes_match_plain(card, slots, t_cap):
    """The Llama-1B decode shape (8 KV heads, G = 4, W = 1, B = 32, P = 16)
    with S x Hkv below (16) and above (192, 320) the 132 SMs, T to 1024."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    generator = torch.Generator(device=card).manual_seed(slots + t_cap)
    nb = t_cap // 32
    entries = torch.randint(1, t_cap + 1, (slots,), generator=generator,
                            device=card).tolist()
    operands = _paged_case(generator, torch.bfloat16, slots, 8, 4, 1, 32, nb,
                           16, entries)
    out = P.paged_decode_attention(*operands, groups=4)
    _assert_paged_close(out, operands, 4)


def test_paged_kernel_rejects_what_it_does_not_take(card):
    from aiko_services_tpu_torch.ops import paged_attention as P
    generator = torch.Generator(device=card).manual_seed(0)
    operands = list(_paged_case(generator, torch.bfloat16, 2, 2, 4, 1, 8, 2,
                                3, [5, 9]))
    with pytest.raises(TypeError, match="one type"):
        P.paged_decode_attention(operands[0].half(), *operands[1:],
                                 groups=4)
    wide = list(operands)
    wide[0] = torch.zeros((2, 2, 4, 128), device=card,
                          dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        P.paged_decode_attention(*wide, groups=4)
    k_int8 = _quantized(operands[1])
    v_int8 = _quantized(operands[2])
    bad = dict(k_int8, s=k_int8["s"][..., :-1].contiguous())
    with pytest.raises(ValueError, match="scale plane has shape"):
        P.paged_decode_attention(operands[0], bad, v_int8, *operands[3:],
                                 groups=4)
    with pytest.raises(TypeError, match="differ in form"):
        P.paged_decode_attention(operands[0], k_int8, operands[2],
                                 *operands[3:], groups=4)
    half_scales = dict(v_int8, s=v_int8["s"].half())
    with pytest.raises(TypeError, match="float32 scales"):
        P.paged_decode_attention(operands[0], k_int8, half_scales,
                                 *operands[3:], groups=4)
    ragged = list(operands)
    ragged[3] = ragged[3][:1]
    with pytest.raises(ValueError, match="tables has shape"):
        P.paged_decode_attention(*ragged, groups=4)
    shifted = list(operands)           # contiguous, 8 bytes off a boundary
    shifted[4] = torch.zeros(operands[4].numel() + 4, device=card,
                             dtype=torch.bfloat16)[4:].view(
                                 operands[4].shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        P.paged_decode_attention(*shifted, groups=4)


def _quantized(pool):
    """The int8 serving form of a native pool, null block 0 all zeros in
    both planes (as BlockPool allocates it)."""
    from aiko_services_tpu_torch.models.layers import quantize_kv_cache
    leaf = quantize_kv_cache(pool)
    leaf["s"][0] = 0
    return leaf


def _variant_operands(operands, variant, dtype):
    """(kernel operands, plain operands, fold) of one numerics variant:
    int8 pools for the kernel, and for the plain version the values the
    kernel sees (folding: int8 values and f32 scales as they are;
    dequantizing: round(q * round(s)) in the compute type)."""
    from aiko_services_tpu_torch.models.layers import dequantize_kv_cache
    fold = variant == "int8_fold"
    operands, plain_operands = list(operands), list(operands)
    if variant != "native":
        operands[1], operands[2] = (_quantized(pool.float())
                                    for pool in operands[1:3])
        plain_operands[1], plain_operands[2] = (
            leaf if fold else dequantize_kv_cache(leaf, dtype)
            for leaf in operands[1:3])
    return operands, plain_operands, fold



@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["native", "int8_fold", "int8_dequant"])
@pytest.mark.parametrize("groups,width", [(4, 16), (1, 65), (4, 64)])
def test_paged_kernel_variants_tile_rows_and_match_plain(card, dtype, variant,
                                                         groups, width):
    """G*W = 64, 65 and 256 query rows (in bf16 the tensor-core path's
    256-row block, rows past G*W padded; in f32 16-row tiles of the
    split path) under a chunk's causal triangle; extents 0 (a first chunk, and with
    one row's side entries all masked: a fully masked row), on a block
    edge, inside a block, and the whole table.  The int8 variants are
    held against the plain version in f32 on the values the kernel sees:
    folding, int8 values and f32 scales as they are; dequantizing, the
    values rounded to the compute type, round(q * round(s))."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    torch_dtype = getattr(torch, dtype)
    generator = torch.Generator(device=card).manual_seed(groups * width)
    nb, block = 4, 16
    entries = [0, 2 * block, block + 3, nb * block]
    operands = list(_paged_case(generator, torch_dtype, 4, 2, groups, width,
                                block, nb, width, entries))
    tri = torch.ones((width, width), dtype=torch.bool,
                     device=card).tril().expand(4, width, width).clone()
    tri[0, 0] = False                     # slot 0, query 0: fully masked
    operands[6] = tri
    name = "paged_decode_attention" + ("" if variant == "native"
                                       else "_" + variant)
    operands, plain_operands, fold = _variant_operands(operands, variant,
                                                       torch_dtype)
    before = dict(P.launches)
    out = P.paged_decode_attention(*operands, groups=groups,
                                   fold_scales=fold)
    assert P.launches[name] == before[name] + 1
    assert sum(P.launches.values()) == sum(before.values()) + 1
    assert out.shape == (4, 2, groups * width, 64)
    _assert_paged_close(out, plain_operands, groups)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["native", "int8_fold", "int8_dequant"])
@pytest.mark.parametrize("groups,width,block", [
    (4, 1, 32), (4, 1, 12), (4, 4, 8), (1, 17, 16), (2, 8, 16)])
def test_paged_kernel_splits_and_path_cut_match_plain(card, dtype, variant,
                                                      groups, width, block):
    """Both device paths (split over T: G*W = 4 and 16 in bf16, and every
    f32 case; tensor cores: G*W = 17 in bf16), B = 8, 12, 16, 32, a table
    of ~256 positions cut into 64-position splits: extents on and either
    side of a split boundary (63, 64, 65, 128, 129), the whole table, and
    0 with slot 0's query 0 fully masked across every split."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    torch_dtype = getattr(torch, dtype)
    generator = torch.Generator(device=card).manual_seed(
        groups * width * 10 + block)
    nb = -(-256 // block)
    entries = [0, 63, 64, 65, 128, 129, nb * block]
    operands, plain_operands, fold = _variant_operands(
        _paged_case(generator, torch_dtype, len(entries), 2, groups, width,
                    block, nb, 5, entries), variant, torch_dtype)
    path, _, split, main_splits = P.kernel_plan(
        dtype == "bfloat16", len(entries), 2, groups * width, nb * block,
        torch.cuda.get_device_properties(card).multi_processor_count)
    assert path == (P.TENSOR_PATH if dtype == "bfloat16" and
                    groups * width > 16 else P.SPLIT_PATH)
    assert path == P.TENSOR_PATH or (split, main_splits) == (
        64, -(-nb * block // 64))
    name = "paged_decode_attention" + ("" if variant == "native"
                                       else "_" + variant)
    before = dict(P.launches)
    out = P.paged_decode_attention(*operands, groups=groups,
                                   fold_scales=fold)
    assert P.launches[name] == before[name] + 1
    assert sum(P.launches.values()) == sum(before.values()) + 1
    _assert_paged_close(out, plain_operands, groups)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["native", "int8_fold", "int8_dequant"])
@pytest.mark.parametrize("block", [8, 16, 32, 24])
def test_paged_kernel_decode_rows_over_block_sizes(card, dtype, variant,
                                                   block):
    """The decode rows (G = 4, W = 1) at B = 8, 16, 32 and 24 (not a
    multiple of 16) over t_cap 512, 16 slots x 8 KV heads, random
    extents and one slot at 0 with its row fully masked."""
    torch_dtype = getattr(torch, dtype)
    generator = torch.Generator(device=card).manual_seed(block)
    nb = 512 // block
    entries = torch.randint(1, nb * block + 1, (16,), generator=generator,
                            device=card).tolist()
    entries[0] = 0
    operands, plain_operands, fold = _variant_operands(
        _paged_case(generator, torch_dtype, 16, 8, 4, 1, block, nb, 8,
                    entries), variant, torch_dtype)
    from aiko_services_tpu_torch.ops import paged_attention as P
    out = P.paged_decode_attention(*operands, groups=4, fold_scales=fold)
    _assert_paged_close(out, plain_operands, 4)


@pytest.mark.parametrize("mixed", [False, True])
def test_mel_collate_pads_card_rows_on_the_card(card, mixed):
    """PE_WhisperASR's mel collate: rows that PE_LogMel left on the card
    are padded there, host rows cross in one pinned copy, and either way
    the padded bf16 batch equals the one collated from host rows."""
    import numpy as np

    from aiko_services_tpu_torch.elements.speech import collate_mel
    generator = torch.Generator(device=card).manual_seed(7)
    rows = [torch.randn(t, 80, generator=generator, device=card)
            for t in (100, 300, 250)]
    on_card = list(rows)
    if mixed:
        on_card[1] = rows[1].cpu().numpy()
    batch = collate_mel(on_card, 8, 300, 80, card)
    host = collate_mel([row.cpu().numpy() for row in rows], 8, 300, 80,
                       card)
    torch.cuda.synchronize()
    assert batch.device.type == "cuda" and batch.dtype is torch.bfloat16
    assert batch.shape == (8, 300, 80)
    assert torch.equal(batch, host)
    assert torch.equal(batch[0, 100:], torch.zeros_like(batch[0, 100:]))
    assert torch.equal(batch[3:], torch.zeros_like(batch[3:]))
    assert np.array_equal(batch[2, :250].float().cpu().numpy(),
                          rows[2].to(torch.bfloat16).float().cpu().numpy())


# -- autograd: the kernels have no backward -----------------------------------

def test_flash_and_cross_decode_refuse_grad(card):
    """A CUDA operand that requires grad under grad mode raises (the
    output, filled through ctypes, would carry no gradient); under
    no_grad or inference_mode the kernels run."""
    generator = torch.Generator(device=card).manual_seed(0)
    q, k, v = (_randn(generator, 1, 2, 128, 64) for _ in range(3))
    qd = _randn(generator, 1, 2, 1, 64)
    for call, query in ((A.flash_attention, q),
                        (A.cross_decode_attention, qd)):
        for operands in ((query.clone().requires_grad_(True), k, v),
                         (query, k, v.clone().requires_grad_(True))):
            with pytest.raises(RuntimeError, match="no backward"):
                call(*operands)
            with torch.no_grad():
                assert torch.isfinite(call(*operands).float()).all()
        with torch.inference_mode():
            assert torch.isfinite(call(query, k, v).float()).all()


def test_paged_kernel_refuses_grad(card):
    from aiko_services_tpu_torch.ops import paged_attention as P
    generator = torch.Generator(device=card).manual_seed(1)
    operands = list(_paged_case(generator, torch.bfloat16, 2, 2, 2, 2, 8, 3,
                                3, [13, 24]))
    for index in (0, 1, 5):                      # q, a pool, a side buffer
        grad = list(operands)
        grad[index] = grad[index].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            P.paged_decode_attention(*grad, groups=2)
        with torch.no_grad():
            assert torch.isfinite(
                P.paged_decode_attention(*grad, groups=2)).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["native", "int8_fold", "int8_dequant"])
@pytest.mark.parametrize("groups,width", [(4, 1), (4, 4), (1, 17), (4, 64)])
def test_paged_kernel_at_head_dim_128_matches_plain(card, dtype, variant,
                                                    groups, width):
    """D = 128 on both paths: split over T (4 and 16-row tiles; f32 at
    most 128 positions a split, so a ~256-position table takes two or
    more splits), tensor cores in bf16 for 17 rows (one 128-row tile)
    and 256 (two); extents 0 (slot 0's query 0 fully masked), around a
    split boundary, inside a block and the whole table; each numerics
    against the plain version on the values the kernel sees."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    torch_dtype = getattr(torch, dtype)
    generator = torch.Generator(device=card).manual_seed(groups * width + 5)
    block, nb = 16, 16
    entries = [0, 127, 128, 129, 19, nb * block]
    operands = list(_paged_case(generator, torch_dtype, len(entries), 2,
                                groups, width, block, nb,
                                width if width > 1 else 5, entries,
                                head_dim=128))
    if width > 1:
        tri = torch.ones((width, width), dtype=torch.bool,
                         device=card).tril()
        operands[6] = tri.expand(len(entries), width, width).clone()
        operands[6][0, 0] = False
    operands, plain_operands, fold = _variant_operands(operands, variant,
                                                       torch_dtype)
    path, tile_rows, split, _ = P.kernel_plan(
        dtype == "bfloat16", len(entries), 2, groups * width, nb * block,
        torch.cuda.get_device_properties(card).multi_processor_count, 128)
    if path == P.TENSOR_PATH:
        assert tile_rows == 128
    else:
        assert split <= (128 if dtype == "float32" else 256)
    name = "paged_decode_attention" + ("" if variant == "native"
                                       else "_" + variant)
    before = dict(P.launches)
    out = P.paged_decode_attention(*operands, groups=groups,
                                   fold_scales=fold)
    assert P.launches[name] == before[name] + 1
    assert out.shape == (len(entries), 2, groups * width, 128)
    _assert_paged_close(out, plain_operands, groups)


@pytest.mark.parametrize("num_kv", [8, 1], ids=["8b", "tp8_rank"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_kernel_llama_8b_decode_shapes_match_plain(card, num_kv,
                                                         dtype):
    """Llama-3-8B's decode rows (G = 4, W = 1, D = 128, B = 32, t_cap
    512, P = 16) over 16 slots with its 8 KV heads, and a TP-8 rank's one
    KV head."""
    from aiko_services_tpu_torch.ops import paged_attention as P
    generator = torch.Generator(device=card).manual_seed(num_kv)
    entries = torch.randint(1, 513, (16,), generator=generator,
                            device=card).tolist()
    operands = _paged_case(generator, getattr(torch, dtype), 16, num_kv, 4,
                           1, 32, 16, 16, entries, head_dim=128)
    out = P.paged_decode_attention(*operands, groups=4)
    _assert_paged_close(out, operands, 4)
