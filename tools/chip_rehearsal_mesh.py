"""Rehearse chip_smoke.py's Whisper-on-a-mesh phases and its cut MoE
drive on the CPU, to predict the counts a chip run must show.

    python tools/chip_rehearsal_mesh.py asr         # pipeline, asr_mesh
    python tools/chip_rehearsal_mesh.py moe         # llama_moe's steps
    python tools/chip_rehearsal_mesh.py train       # train_mesh
    python tools/chip_rehearsal_mesh.py elements    # elements_mesh

The devices resolve to the CPU as tools/chip_rehearsal.py resolves them
(its stand_ins).  Whisper-small is a one-layer stand-in of one 64-wide
head with the real vocabulary and mel frontend: the pipeline's batches
and its flash dispatches a layer depend on frame lengths and the virtual
clock alone, and the flash wrapper's plain version counts a launch per
call, as the wrapper counts its kernel's.  8x1b is a 64-wide stand-in
with the real vocabulary (the seeded traffic's lengths are drawn beside
its token ids) and 16 layers.  train runs train_mesh at Whisper-small's
widths, its one-rank gloo mesh taken for the card's NCCL one.
elements runs elements_mesh at full size (PE_NeuralTTS at base,
ResNet-18 at 224).  Each phase prints its records and raises where a
check fails."""

# a console script: its printed records are its output
# graft: disable-file=lint-print

import dataclasses
import os
import sys
import tempfile

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_rehearsal import OnTheCpu, stand_ins  # noqa: E402


def whisper_stand_in(chip_smoke) -> None:
    from aiko_services_tpu_torch.models.whisper import WHISPER_PRESETS
    from aiko_services_tpu_torch.ops import attention as A

    small = WHISPER_PRESETS["small"]
    WHISPER_PRESETS["small"] = dataclasses.replace(
        small, dim=64, num_heads=1, enc_layers=1, dec_layers=1)
    chip_smoke.WHISPER_SMALL = (64, 1, 1, 1, small.n_vocab)
    chip_smoke.FLASH_SHAPES["pipeline"] = (32, 1, 1536, 64)
    plain = A.flash_attention_reference

    def counted(q, k, v, causal=False, scale=None):
        A.launches["flash_attention"] += 1
        return plain(q, k, v, causal=causal, scale=scale)
    A.flash_attention = counted


def moe_stand_in(chip_smoke) -> None:
    real = chip_smoke.moe_8x1b
    chip_smoke.moe_8x1b = lambda **changes: real(
        dim=64, num_heads=4, num_kv_heads=2, ffn_dim=128, **changes)


def run(chip_smoke, phases) -> int:
    from aiko_services_tpu_torch.parallel import create_mesh
    with OnTheCpu():
        if "asr" in phases:
            whisper_stand_in(chip_smoke)
            counts, tokens = chip_smoke.phase_pipeline()
            meshed, meshed_tokens = chip_smoke.phase_pipeline(
                mesh=create_mesh({"model": 1}), phase="asr_mesh")
            print("pipeline launches", counts, "asr_mesh launches", meshed,
                  "tokens equal", tokens == meshed_tokens)
            if meshed != counts or tokens != meshed_tokens:
                raise AssertionError("asr_mesh differs from pipeline")
        if "moe" in phases:
            moe_stand_in(chip_smoke)
            print("llama_moe launches", chip_smoke.phase_llama_moe())
        if "elements" in phases:
            print("elements_mesh attention launches",
                  chip_smoke.phase_elements_mesh())
        if "train" in phases:
            # the phase's own check reads the backend: gloo stands for
            # the card's NCCL there, and only there
            get_backend = dist.get_backend

            def backend(*args):
                caller = sys._getframe(1).f_globals.get("__name__")
                return "nccl" if caller == "chip_smoke" else \
                    get_backend(*args)
            dist.get_backend = backend
            try:
                chip_smoke.phase_train_mesh()
            finally:
                dist.get_backend = get_backend
    dist.destroy_process_group()
    return 0


def main(phases) -> int:
    # DTensor's module annotates with torch.Generator, which the stand-ins
    # replace: import it first
    import torch.distributed.fsdp  # noqa: F401
    import torch.distributed.tensor  # noqa: F401
    chip_smoke = stand_ins()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as directory:
        dist.init_process_group(
            "gloo", init_method=f"file://{directory}/store", rank=0,
            world_size=1)
        return run(chip_smoke, phases)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["asr", "moe"]))
