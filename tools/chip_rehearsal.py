"""Rehearse chip_smoke.py's agent phases on the CPU, to predict the
counts a chip run must show.

    python tools/chip_rehearsal.py agent_8b           # agent_8b's drive
    python tools/chip_rehearsal.py disagg modes       # agent_disagg, then
                                                      # agent_mesh_modes
    python tools/chip_rehearsal.py migrate            # agent_migrate, then
                                                      # agent_migrate_mesh
    python tools/chip_rehearsal.py operator_scripts   # the operator scripts
    python tools/chip_rehearsal.py llama_wq decoder_chaos   # at 8 layers
    python tools/chip_rehearsal.py surface            # models.greedy_decode

Every device resolves to the CPU (each port module's resolve_device, a
TorchFunctionMode rewriting device="cuda" and pinned allocations,
torch.Generator ignoring its device, parallel.create_mesh on gloo), the
torch.cuda timers and the sync debug mode are stubbed, and the paged
kernel's plain version counts a launch per call by variant, as the
wrapper counts its kernel's.  The 1b preset is a 64-wide 16-layer
stand-in and the 8b one a 4-layer 256-wide stand-in at head dim 128: the
phases' schedules depend on neither widths nor token values while their
cache budgets are in blocks, so the decode steps, extend dispatches,
launches, batch cuts, transfers and host-tier installs are the card's;
times, memory and the host tier's byte budget are not.  The surface
phase runs Whisper-small as a 128-wide stand-in (two heads of 64, its
12 + 12 layers and 51,865-token vocabulary kept), with the flash
kernel's plain version counting a launch per call: its flash launches
depend on the encoder's depth and the bucket alone.  Each phase
prints its record (the JSON line chip_smoke.py emits) and raises where
a check fails."""

# a console script: its printed records are its output
# graft: disable-file=lint-print

import dataclasses
import importlib
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import aiko_services_tpu_torch as port  # noqa: E402

CPU = torch.device("cpu")
MODULES = ("serving", "serving_paged", "compute", "models.llama",
           "models.whisper", "parallel.mesh", "elements.speech",
           "elements.audio", "bridge")


class OnTheCpu(TorchFunctionMode):
    """device="cuda" arguments and pinned allocations, on the CPU."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        device = kwargs.get("device")
        if device is not None and str(device).startswith("cuda"):
            kwargs["device"] = "cpu"
        if kwargs.get("pin_memory"):
            kwargs["pin_memory"] = False
        return func(*args, **kwargs)


def stand_ins():
    """Patch the port and chip_smoke for the CPU; returns chip_smoke."""
    def resolve(device=None):
        return CPU

    port.resolve_device = resolve
    for name in MODULES:
        module = importlib.import_module(f"aiko_services_tpu_torch.{name}")
        if hasattr(module, "resolve_device"):
            module.resolve_device = resolve
    generator = torch.Generator
    torch.Generator = lambda device=None: generator()
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "set_sync_debug_mode"):
        setattr(torch.cuda, name, lambda *args, **kwargs: None)
    torch.cuda.max_memory_allocated = lambda *args, **kwargs: 0

    from aiko_services_tpu_torch import parallel
    from aiko_services_tpu_torch.parallel import mesh
    create_mesh = mesh.create_mesh
    parallel.create_mesh = mesh.create_mesh = \
        lambda axes=None, device=None: create_mesh(axes, device="cpu")

    from aiko_services_tpu_torch.ops import paged_attention as P
    plain = P.paged_decode_attention_reference

    def counted(q, k_pool, *args, fold_scales=True, **kwargs):
        if isinstance(k_pool, dict):
            P.launches["paged_decode_attention_int8_fold" if fold_scales
                       else "paged_decode_attention_int8_dequant"] += 1
        else:
            P.launches["paged_decode_attention"] += 1
        return plain(q, k_pool, *args, fold_scales=fold_scales, **kwargs)

    P.paged_decode_attention_reference = counted

    import chip_smoke
    from aiko_services_tpu_torch.models.llama import LLAMA_PRESETS
    chip_smoke.check_1b = lambda config: None
    LLAMA_PRESETS["1b"] = dataclasses.replace(
        LLAMA_PRESETS["1b"], dim=64, num_heads=4, num_kv_heads=2,
        ffn_dim=128, vocab=4096, num_layers=16)
    eight = dataclasses.replace(LLAMA_PRESETS["8b"], dim=256, num_heads=2,
                                num_kv_heads=1, ffn_dim=512, vocab=4096,
                                num_layers=4, max_seq_len=1024)
    chip_smoke.llama_8b = lambda **changes: dataclasses.replace(eight,
                                                                **changes)
    chip_smoke.emit = lambda record: print(json.dumps(record, default=str),
                                           flush=True)
    return chip_smoke


def surface(chip_smoke) -> int:
    """chip_smoke.phase_surface on a narrow Whisper-small stand-in, the
    flash wrapper's CPU path counting a launch per call."""
    from aiko_services_tpu_torch.models.whisper import WHISPER_PRESETS
    from aiko_services_tpu_torch.ops import attention as A

    small = dataclasses.replace(WHISPER_PRESETS["small"], dim=128,
                                num_heads=2)
    WHISPER_PRESETS["small"] = small
    chip_smoke.WHISPER_SMALL = (small.dim, small.num_heads,
                                small.enc_layers, small.dec_layers,
                                small.n_vocab)
    b, _, s, d = chip_smoke.FLASH_SHAPES["surface"]
    chip_smoke.FLASH_SHAPES["surface"] = (b, small.num_heads, s, d)
    plain = A.flash_attention_reference

    def counted(q, k, v, **kwargs):
        A.launches["flash_attention"] += 1
        return plain(q, k, v, **kwargs)

    A.flash_attention_reference = counted
    try:
        return chip_smoke.phase_surface("(the CPU)")
    finally:
        A.flash_attention_reference = plain


def main(phases) -> int:
    chip_smoke = stand_ins()
    if not dist.is_initialized():
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        with tempfile.TemporaryDirectory() as directory:
            dist.init_process_group(
                "gloo", init_method=f"file://{directory}/store", rank=0,
                world_size=1)
            return run(chip_smoke, phases)
    return run(chip_smoke, phases)


def run(chip_smoke, phases) -> int:
    with OnTheCpu():
        if "agent_8b" in phases:
            print("agent_8b launches", chip_smoke.phase_agent_8b())
        if "migrate" in phases:
            counts, tokens = chip_smoke.phase_agent_migrate()
            print("agent_migrate launches", counts)
            print("agent_migrate_mesh launches",
                  chip_smoke.phase_agent_migrate_mesh(tokens))
        if "operator_scripts" in phases:
            print("operator_scripts launches",
                  chip_smoke.phase_operator_scripts())
        if "llama_wq" in phases:
            print("llama_wq launches", chip_smoke.phase_llama_wq())
        if "decoder_chaos" in phases:
            print("decoder_chaos launches", chip_smoke.phase_decoder_chaos())
        if "surface" in phases:
            print("surface launches", surface(chip_smoke))
        if "disagg" in phases or "modes" in phases:
            counts, tokens = chip_smoke.phase_agent_disagg()
            print("agent_disagg launches", counts)
            if "modes" in phases:
                print("agent_mesh_modes launches",
                      chip_smoke.phase_agent_mesh_modes(tokens))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["agent_8b"]))
