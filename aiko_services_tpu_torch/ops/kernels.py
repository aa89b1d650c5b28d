# Build and load the port's CUDA kernels (csrc/*.cu).
#
# Each source is a self-contained CUDA C++ file with a plain C interface,
# compiled by nvcc for sm_90a into its own shared library and loaded with
# ctypes (no PyTorch headers, so a build takes seconds, not minutes).
# Libraries land in aiko_services_tpu_torch/_build/ (listed in
# .gitignore), named by a hash of the source and the flags, and are built
# at first use.  Several sources build in parallel: one nvcc process each.
#
# Nothing CUDA-specific is imported or run when this module is imported,
# so the CPU tests import the package on a machine without nvcc.

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build", "load", "entry",
           "check", "require_cuda", "nvcc_path"]

_PACKAGE = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE / "csrc"
_BUILD = _PACKAGE / "_build"

KERNEL_SOURCES = ("flash_attention", "cross_decode_attention",
                  "paged_decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# reported, not part of the library's identity: it changes no code
_VERBOSE_FLAGS = ("-Xptxas", "-v")

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc/ptxas output of its build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "aiko_services_tpu_torch/csrc at first use and need the CUDA "
        "toolkit (put nvcc on PATH or set CUDA_HOME)")


def _library_path(name: str) -> tuple[Path, Path]:
    source = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return source, _BUILD / f"{name}-{digest}.so"


def build(names=KERNEL_SOURCES) -> list[str]:
    """Compile every named source whose library is missing, all nvcc
    processes started together.  Returns the names it built; raises
    RuntimeError with the compiler's output if any build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        source, target = _library_path(name)
        if target.exists():
            continue
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        command = [nvcc_path(), *NVCC_FLAGS, *_VERBOSE_FLAGS,
                   "-o", str(partial), str(source)]
        process = subprocess.Popen(command, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, partial, process))
    failures = []
    for name, target, partial, process in jobs:
        output, _ = process.communicate()
        build_log[name] = output
        if process.returncode != 0:
            failures.append(f"{name} (nvcc exit {process.returncode}):\n"
                            f"{output}")
            partial.unlink(missing_ok=True)
        else:
            os.replace(partial, target)      # atomic: no half-written .so
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return [name for name, *_ in jobs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    with _lock:
        library = _libraries.get(name)
        if library is None:
            build((name,))
            library = ctypes.CDLL(str(_library_path(name)[1]))
            library.aiko_error_string.argtypes = [ctypes.c_int]
            library.aiko_error_string.restype = ctypes.c_char_p
            _libraries[name] = library
        return library


def entry(source: str, symbol: str, argtypes):
    """(library, C function) of one kernel, built and loaded at first
    use, with its ctypes signature declared."""
    library = load(source)
    function = getattr(library, symbol)
    function.argtypes = argtypes
    function.restype = ctypes.c_int
    return library, function


def require_cuda(name: str, tensor) -> None:
    """A wrapper's guard after its CPU branch: a tensor anywhere but on
    the card has no kernel."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tensor.device}")


def check(library: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if code != 0:
        message = library.aiko_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({message})")
