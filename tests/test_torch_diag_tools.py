"""The port's diagnostic and experiment tools (aiko_services_tpu_torch/
tools/diag_membw.py, diag_attn_patterns.py, diag_whisper_tail.py,
measure_reference_baseline.py, train_vocoder_scale.py) on the CPU at
tiny sizes, where a time means nothing: their arithmetic, their patterns
against the JAX tools' definitions, the kernel rows' checks (a kernel
that drops a key or reads another slot's blocks fails them), and the vocoder
sweep's corpus and MCD against the JAX tool's on the same weights.  The
tools measure on an H100; their numbers are in PERF.md."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.tools import (diag_attn_patterns, diag_membw,
                                           diag_whisper_tail,
                                           measure_reference_baseline,
                                           train_vocoder_scale)

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "tools")
TINY_REPS = (2, 6)


def repo_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_marginal_rate_is_the_extra_reps_bytes_over_their_time(
        monkeypatch):
    times = {2: 0.010, 6: 0.030}
    monkeypatch.setattr(diag_membw, "timed_chain",
                        lambda fn, device, chain, repeats: times[fn()])
    row = diag_membw.marginal_rate("probe", lambda reps: (lambda: reps),
                                   1e9, "cpu", reps=TINY_REPS)
    assert row["gbps"] == pytest.approx(1e9 * 4 / 0.020 / 1e9)
    assert row["share_of_spec"] == pytest.approx(200e9 / 3.35e12)


def test_membw_patterns_read_what_they_count():
    generator = torch.Generator().manual_seed(0)
    x = torch.randn((4096,), generator=generator).to(torch.bfloat16)
    build, nbytes = diag_membw.slicesum(x)
    assert nbytes == (4096 - 256) * 2
    expected = sum(float(x[(37 * i) % 256:][:4096 - 256].float().sum())
                   for i in range(3))
    assert float(build(3)()) == pytest.approx(expected, rel=1e-5)
    a = torch.randn((64, 16), generator=generator).to(torch.bfloat16)
    v0 = torch.randn((16,), generator=generator).to(torch.bfloat16)
    build, nbytes = diag_membw.matvec(a, v0)
    assert nbytes == 64 * 16 * 2 + 16 * 2
    v = v0
    for _ in range(3):            # the previous product feeds the next
        y = torch.mv(a, v).float()[:16]
        v = (y / y.abs().amax()).to(torch.bfloat16)
    torch.testing.assert_close(build(3)(), v)


def test_membw_measure_runs_both_patterns_on_the_cpu():
    rows = diag_membw.measure("cpu", slice_elements=1 << 14,
                              matrix_rows=256, width=64, repeats=1,
                              reps=TINY_REPS)
    assert set(rows) == {"slicesum", "matvec", "ceiling_gbps"}
    assert rows["ceiling_gbps"] == max(rows["slicesum"]["gbps"],
                                       rows["matvec"]["gbps"])


def test_attend_is_softmax_attention_with_folded_int8_scales():
    generator = torch.Generator().manual_seed(1)
    q = torch.randn((2, 3, 1, 8), generator=generator).to(torch.bfloat16)
    k = torch.randn((2, 3, 5, 8), generator=generator).to(torch.bfloat16)
    v = torch.randn((2, 3, 5, 8), generator=generator).to(torch.bfloat16)
    want = torch.softmax(q.float() @ k.float().transpose(-1, -2) /
                         math.sqrt(8), dim=-1) @ v.float()
    torch.testing.assert_close(diag_attn_patterns.attend(q, k, v).float(),
                               want, atol=2e-2, rtol=2e-2)
    ki = torch.randint(-127, 128, (2, 3, 5, 8), generator=generator,
                       dtype=torch.int8)
    vi = torch.randint(-127, 128, (2, 3, 5, 8), generator=generator,
                       dtype=torch.int8)
    scale = 1.0 / 127.0
    want = torch.softmax(q.float() @ (ki.float() * scale).transpose(-1, -2)
                         / math.sqrt(8), dim=-1) @ (vi.float() * scale)
    torch.testing.assert_close(
        diag_attn_patterns.attend(q, ki, vi, scale, scale).float(), want,
        atol=2e-2, rtol=2e-2)


def test_paged_operands_hold_the_same_kv_and_the_check_catches_faults():
    """The pool and table give back K/V [S, Hkv, T, D] block for block;
    the plain paged version over them equals dense attention, and the
    check fails a kernel that drops a key or reads another slot's
    blocks."""
    from aiko_services_tpu_torch.models.layers import gather_paged_kv
    from aiko_services_tpu_torch.ops import paged_attention as P

    generator = torch.Generator().manual_seed(2)
    s, hkv, g, d, t = 3, 2, 4, 16, 64
    k = torch.randn((s, hkv, t, d), generator=generator).to(torch.bfloat16)
    v = torch.randn((s, hkv, t, d), generator=generator).to(torch.bfloat16)
    q = torch.randn((s, hkv, g, d), generator=generator).to(torch.bfloat16)
    operands = diag_attn_patterns.paged_operands(k, v, 16)
    k_pool, v_pool, tables = operands[:3]
    assert k_pool.shape == (1 + s * 4, hkv, 16, d)
    assert bool((k_pool[0] == 0).all())
    torch.testing.assert_close(gather_paged_kv(k_pool, tables), k)
    torch.testing.assert_close(gather_paged_kv(v_pool, tables), v)
    held = diag_attn_patterns.check_paged(q, operands, g)
    assert held["rel_l2"] <= P.TOLERANCE[P.TENSOR_PATH][1]
    dense = diag_attn_patterns.attend(q, k, v).float()
    torch.testing.assert_close(P.paged_decode_attention(
        q, *operands, groups=g, scale=1.0 / math.sqrt(d)), dense,
        atol=2e-2, rtol=2e-2)

    def dropping(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                 lengths, **kwargs):
        return P.paged_decode_attention(q, k_pool, v_pool, tables, k_side,
                                        v_side, side_valid, lengths - 1,
                                        **kwargs)

    def other_slots(q, k_pool, v_pool, tables, *rest, **kwargs):
        return P.paged_decode_attention(q, k_pool, v_pool,
                                        tables.roll(1, dims=0), *rest,
                                        **kwargs)
    for faulty in (dropping, other_slots):
        with pytest.raises(AssertionError, match="gqa4/kernel"):
            diag_attn_patterns.check_paged(q, operands, g, kernel=faulty)


def test_cross_check_holds_the_plain_version_and_catches_a_dropped_key():
    from aiko_services_tpu_torch.ops import attention as A

    generator = torch.Generator().manual_seed(3)
    q = torch.randn((2, 3, 1, 64), generator=generator).to(torch.bfloat16)
    k = torch.randn((2, 3, 40, 64), generator=generator).to(torch.bfloat16)
    v = torch.randn((2, 3, 40, 64), generator=generator).to(torch.bfloat16)
    held = diag_attn_patterns.check_cross(q, k, v)
    assert held["rel_l2"] <= A.CROSS_TOLERANCE[2]
    with pytest.raises(AssertionError, match="mha1/kernel"):
        diag_attn_patterns.check_cross(
            q, k, v, kernel=lambda q, k, v: A.cross_decode_attention(
                q, k[:, :, 1:], v[:, :, 1:]))


def test_attn_patterns_run_every_row_on_the_cpu():
    result = diag_attn_patterns.run(
        "cpu", gqa={"slots": 2, "kv_heads": 2, "groups": 4,
                    "head_dim": 64, "t": 64, "block": 32},
        mha={"batch": 2, "heads": 2, "head_dim": 64, "t": 64},
        ceiling_gbps=1.0, repeats=1, reps=TINY_REPS)
    # a row may read "over the data sheet" here (CPU times at two tiny
    # rep counts are noise); the kernel rows' checks must hold
    assert not {"gqa4/kernel", "mha1/kernel"} & set(result["failed"])
    assert set(result["rows"]) == {"gqa4", "gqa4/kernel", "mha1", "mha8",
                                   "mha1/kernel", "mha1q"}
    assert set(result["checks"]) == {"gqa4/kernel", "mha1/kernel"}


def test_whisper_tail_arithmetic_matches_the_jax_tool():
    jax_tool = repo_tool("diag_whisper_tail")
    config = diag_whisper_tail.tail_config(250)
    assert diag_whisper_tail.cross_kv_bytes_per_frame(config) == \
        jax_tool.cross_kv_bytes_per_frame(jax_tool.tail_config(250))
    assert (diag_whisper_tail.BATCH, diag_whisper_tail.MAX_TOKENS) == \
        (jax_tool.BATCH, jax_tool.MAX_TOKENS)
    steps = [1.0 + 0.004 * ctx for ctx in diag_whisper_tail.CONTEXTS]
    result = diag_whisper_tail.fit(diag_whisper_tail.CONTEXTS, steps, 1000)
    assert result["slope_us_per_frame"] == pytest.approx(4.0)
    assert result["intercept_ms"] == pytest.approx(1.0)
    assert result["gbps"] == pytest.approx(1000 / 4e-6 / 1e9)


def test_whisper_tail_runs_at_a_tiny_geometry_on_the_cpu():
    result = diag_whisper_tail.run(
        "cpu", preset="test", batch=2, contexts=(8, 16), max_tokens=3,
        ladder_batches=(2,), ceiling_gbps=1.0, chain=1, repeats=1)
    assert len(result["steps_ms"]) == 2
    assert set(result["ladder"]) == {2}


def test_baseline_ours_drives_the_ports_mailboxes():
    result = measure_reference_baseline.measure_ours(0.3)
    assert result["which"] == "aiko_services_tpu_torch"
    assert result["messages"] > 0 and result["cpu"]
    jax_result = repo_tool("measure_reference_baseline").measure_ours(0.3)
    assert set(jax_result) | {"cpu"} == set(result)
    with pytest.raises(SystemExit):
        measure_reference_baseline.main([])     # a mode must be named


def test_vocoder_sweep_runs_and_corpora_match_the_jax_tool():
    jax_tool = repo_tool("train_vocoder_scale")
    runs = {name: (texts, config, steps, window) for name, texts, config,
            steps, window in train_vocoder_scale.runs()}
    assert list(runs) == ["base8", "wide", "wide128", "wide192"]
    assert runs["base8"][0] == jax_tool.base_corpus()
    assert runs["wide"][0] == jax_tool.wide_corpus()
    assert len(runs["wide"][0]) == 29
    for name, channels, basis, steps, window in (
            ("base8", (96, 48, 24), 64, 6000, 64),
            ("wide", (96, 48, 24), 64, 9000, 96),
            ("wide128", (128, 64, 32), 64, 9000, 96),
            ("wide192", (192, 96, 48), 96, 9000, 96)):
        texts, config, got_steps, got_window = runs[name]
        assert (config.channels, config.basis, got_steps, got_window) == \
            (channels, basis, steps, window)
    assert [name for name, *_ in train_vocoder_scale.runs(["wide"])] == \
        ["wide"]
    with pytest.raises(ValueError, match="unknown runs"):
        train_vocoder_scale.runs(["nope"])


def test_held_out_mcd_matches_the_jax_tool_on_the_same_weights(tmp_path):
    """The port's held-out copy-synthesis MCD of one vocoder, and the
    JAX tool's on the same weights, within 0.05 dB."""
    import jax

    from aiko_services_tpu.elements.speech import load_flat_npz
    from aiko_services_tpu.models import vocoder as JV
    from aiko_services_tpu_torch.bridge import save_flat_npz
    from aiko_services_tpu_torch.models.vocoder import (VOCODER_PRESETS,
                                                        vocoder_init)

    corpus = train_vocoder_scale.golden()
    config = VOCODER_PRESETS["test"]
    params = vocoder_init(torch.Generator().manual_seed(4), config,
                          device="cpu")
    save_flat_npz(params, str(tmp_path / "vocoder.npz"))
    jax_params = load_flat_npz(JV.vocoder_init(
        jax.random.PRNGKey(0), JV.VOCODER_PRESETS["test"]),
        str(tmp_path / "vocoder.npz"))
    port = corpus.held_out_mcd(params, config, device="cpu")
    reference = repo_tool("train_vocoder_scale").held_out_mcd(
        jax_params, JV.VOCODER_PRESETS["test"])
    assert np.isfinite(port)
    assert port == pytest.approx(reference, abs=0.05)
