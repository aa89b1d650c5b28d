"""The port's in-program A/B tools (aiko_services_tpu_torch/tools/) at a
tiny size on the CPU: each runs its cases, prints one row a case and
returns; the decode A/B reports a case that raises and exits 1, and holds
the paged step's attention calls against the plain version before it
times the paged pair.  On the CPU both paged cases run the plain version
and every time is a CPU time: the A/B means something only on the card,
which is each tool's default device."""

import os
import subprocess
import sys

import pytest
import torch

from aiko_services_tpu_torch.ops import paged_attention as P
from aiko_services_tpu_torch.tools import ab_cross_kv, ab_decode_attention
from aiko_services_tpu_torch.tools import ab_w8
from aiko_services_tpu_torch.tools.timing import timed_chain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"num_steps": 2, "chains": 1}
LABELS = ["two_pass/select", "online/select", "vpu/select",
          "two_pass/block", "paged/gather", "paged/kernel"]
CASES = ab_decode_attention.cases


def tiny_cases(preset, slots, cache_t, device=None):
    return CASES(preset, slots, cache_t, device=device, **TINY)


def test_timed_chain_counts_a_warm_up_and_the_chains():
    calls = []
    seconds = timed_chain(lambda: calls.append(1), "cpu", chain=3,
                          repeats=2)
    assert len(calls) == 1 + 3 * 2 and seconds >= 0.0


def test_decode_ab_prints_each_case(monkeypatch, capsys):
    monkeypatch.setattr(ab_decode_attention, "cases", tiny_cases)
    assert ab_decode_attention.main(["tiny", "4", "64"], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("paged/kernel held against paged/gather")
    assert [line.split(":")[0].strip() for line in lines[1:]] == LABELS
    assert all("ms/step (tiny, 4 slots, cache 64, cpu)" in line
               for line in lines[1:])


def test_decode_ab_exits_one_when_a_case_raises(monkeypatch, capsys):
    def broken():
        raise RuntimeError("broken case")

    monkeypatch.setattr(
        ab_decode_attention, "cases",
        lambda *args, **kwargs: tiny_cases(*args, **kwargs)[:1] +
        [("broken", broken)])
    assert ab_decode_attention.main(["tiny", "4", "64"], device="cpu") == 1
    captured = capsys.readouterr()
    assert "broken           : FAILED RuntimeError('broken case')" in \
        captured.out
    assert "FAILED cases: broken" in captured.err


def test_decode_ab_skips_the_paged_pair_when_the_check_fails(monkeypatch,
                                                             capsys):
    def disagrees(*args, **kwargs):
        raise AssertionError("paged kernel disagrees")

    monkeypatch.setattr(ab_decode_attention, "cases", tiny_cases)
    monkeypatch.setattr(ab_decode_attention, "check_paged", disagrees)
    assert ab_decode_attention.main(["tiny", "4", "64"], device="cpu") == 1
    out = capsys.readouterr().out
    assert "paged/check      : FAILED" in out
    assert "paged/gather" not in out and "two_pass/block" in out


def test_paged_check_holds_every_call_and_leaves_the_wrapper_bound():
    kept = P._paged_decode_attention
    held = ab_decode_attention.check_paged("tiny", 4, 64, num_steps=2,
                                           device="cpu")
    # two rounds of two steps, two layers: one attention call a layer a
    # step; the staggered lengths reach past the 64-position table
    assert held["calls"] == 8
    assert held["max_entry_length"] > 64
    assert held["bound_ratio"] <= 1.0 and held["rel_l2"] <= \
        P.TOLERANCE[P.TENSOR_PATH][1]
    assert P._paged_decode_attention is kept


def _misreading(fault):
    """A stand-in for the kernel that answers with the plain version
    over operands read wrongly: another slot's table row, the blocks of
    its own row rolled by one, or one position too many or too few."""
    plain = P.paged_decode_attention_reference

    def stand_in(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                 entry_lengths, *, groups, scale=None, fold_scales=True):
        if fault == "slot_0_table":
            tables = tables[:1].expand_as(tables)
        elif fault == "rolled_blocks":
            tables = torch.roll(tables, 1, dims=1)
        else:
            entry_lengths = entry_lengths + (1 if fault == "one_more"
                                             else -1)
            entry_lengths = entry_lengths.clamp_min(0)
        if scale is None:
            scale = q.shape[-1] ** -0.5
        return plain(q, k_pool, v_pool, tables, k_side, v_side, side_valid,
                     entry_lengths, groups=groups, scale=scale,
                     fold_scales=fold_scales)

    return stand_in


@pytest.mark.parametrize("fault", ["slot_0_table", "rolled_blocks",
                                   "one_more", "one_fewer"])
def test_paged_check_rejects_a_kernel_that_misreads_the_pool(monkeypatch,
                                                             fault):
    monkeypatch.setattr(P, "_paged_decode_attention", _misreading(fault))
    with pytest.raises(AssertionError, match="disagrees with its plain"):
        ab_decode_attention.check_paged("tiny", 4, 64, num_steps=2,
                                        device="cpu")


def test_paged_gather_case_binds_the_plain_version_only_inside(monkeypatch):
    seen = []
    plain = P.paged_decode_attention_reference

    def counting(*args, **kwargs):
        seen.append(P._paged_decode_attention)
        return plain(*args, **kwargs)

    monkeypatch.setattr(P, "paged_decode_attention_reference", counting)
    kept = P._paged_decode_attention
    ab_decode_attention.measure_paged(False, "tiny", 2, 32, device="cpu",
                                      **TINY)
    assert seen and all(bound is ab_decode_attention._gather_attention
                        for bound in seen)
    assert P._paged_decode_attention is kept


def test_cross_kv_ab_prints_each_mode(capsys):
    results = ab_cross_kv.run(preset="test", batch=2, max_tokens=4,
                              n_audio_ctx=20, chain=1, repeats=1,
                              device="cpu")
    splits = results.pop("splits")
    assert list(results) == list(ab_cross_kv.MODES)
    for seconds, tokens, lengths in results.values():
        assert seconds > 0 and tokens.shape == (2, 4)
        assert lengths.shape == (2,)
    assert list(splits) == ["position", "tensor"]
    assert all(witness["compared"] == 2 and 0 <= witness["reproduced"] <=
               witness["splits"] <= 2 for witness in splits.values())
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "mode False   ", "mode position", "mode tensor  ",
        "mode position", "mode position splits", "mode tensor  ",
        "mode tensor   splits"]
    assert "token match" in lines[3] and "round delta" in lines[5]


@pytest.mark.parametrize("mode", ["w8", "fuse"])
def test_w8_ab_prints_each_mode(capsys, mode):
    result = ab_w8.run(mode=mode, window=0.2, preset="tiny", slots=4,
                       steps_per_sync=4, new_tokens=8, prompts=4,
                       device="cpu")
    option = ab_w8.MODE_KWARGS[mode]
    for enabled in (False, True):
        assert result[enabled]["tokens_per_s"] > 0
        assert result[enabled]["device_step_ms"] > 0
    assert 0.0 <= result["parity"] <= 1.0
    witness = result["splits"]
    assert witness["compared"] == 4
    assert 0 <= witness["reproduced"] <= witness["splits"] <= 4
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{option}=False: ")
    assert lines[1].startswith(f"{option}=True: ")
    assert lines[2].startswith("token parity (4 fixed prompts")
    assert lines[3].startswith(f"{option} splits: ")


def test_split_witness_reproduces_a_split_the_option_makes():
    from aiko_services_tpu_torch.tools.splits import line, split_row, \
        summary
    base = torch.tensor([0.0, 1.0, 0.98, -3.0])
    option = base + torch.tensor([0.0, 0.0, 0.05, 0.0])
    row = split_row(base, option, 1, 2)
    assert row["base_margin"] == pytest.approx(0.02)
    assert row["option_margin"] == pytest.approx(0.03)
    assert row["top2_gap"] == pytest.approx(0.02)
    assert row["shift"] == pytest.approx(0.05)
    assert row["relative_shift"] == pytest.approx(
        0.025 / float(base.std()))
    # the option's logits keep the base token first: not reproduced
    kept = split_row(base, base, 1, 2)
    witness = summary([row, kept], compared=5)
    assert (witness["splits"], witness["reproduced"]) == (2, 1)
    assert "2 of 5 sequences split, 1 reproduced" in line("x", witness)
    assert line("x", summary([], 3)) == "x: no split in 3 sequences"


@pytest.mark.parametrize("tool,env", [
    ("ab_decode_attention", {}), ("ab_cross_kv", {}), ("ab_w8", {}),
    ("ab_w8", {"AB_MODE": "bogus"})],
    ids=["decode", "cross_kv", "w8", "w8_unknown_mode"])
def test_tools_exit_one_without_the_card(tool, env):
    # the tools' default device is the card: with none, or with an
    # unknown AB_MODE, the process exits 1 before timing anything
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    result = subprocess.run(
        [sys.executable, "-m", f"aiko_services_tpu_torch.tools.{tool}"],
        cwd=ROOT, env={**os.environ, **env}, capture_output=True,
        text=True, timeout=120)
    assert result.returncode == 1, result.stderr
    expected = "KeyError: 'bogus'" if env else "no CUDA device"
    assert expected in result.stderr
