# aiko_services_tpu_torch: the PyTorch/CUDA port of aiko_services_tpu.
#
# The port's compute plane runs on one NVIDIA H100: plain tensor code is
# PyTorch, and each kernel the JAX package wrote in Pallas is a CUDA C++
# kernel for sm_90a (csrc/, built at first use by ops/kernels.py).  The
# module layout mirrors aiko_services_tpu so each counterpart is found at
# the same relative path.  Nothing here imports jax or aiko_services_tpu.
#
# Device policy: every entry point takes device=None, which means the
# card; the CPU runs only when a caller passes device="cpu" (the tests).

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "torch_dtype"]


def resolve_device(device=None) -> torch.device:
    """None → the CUDA card (raises when there is none); anything else →
    torch.device(device).  The CPU is never chosen implicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "aiko_services_tpu_torch: no CUDA device is available; "
                "pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(dtype) -> torch.dtype:
    """Map a dtype spelling to a torch dtype: a torch dtype passes
    through; numpy dtypes, the JAX scalar types (jnp.bfloat16 /
    jnp.float32, matched by name, so jax is never imported) and the
    strings "bfloat16" / "float32" / "float16" map by name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]
