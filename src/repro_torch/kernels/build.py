"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into
``build/kernels/lib<name>-<hash>.so`` under the repository root (a directory
that ``.gitignore`` lists), the first time it is needed. The hash covers the
source, every header in ``csrc/`` and the flags, so an edited source or
header is rebuilt. The one driver-API function used (the TMA descriptor
encoder) is reached through the CUDA runtime's driver entry point, so
nothing links against libcuda. The libraries have a
plain C interface and are loaded with ctypes; nothing includes PyTorch's
headers, so a build takes seconds. ``build_all`` starts one ``nvcc`` per
source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "flash_prefill", "moe_grouped")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# the wrappers whose ``launches`` count their calls that launched (``counted``)
COUNTED: list = []


def counted(fn):
    """Registers a kernel wrapper in ``COUNTED`` and starts its
    ``launches`` at 0; the wrapper adds 1 to it on each call that launched.
    Code that launches the kernels without their wrappers keeps the counts
    true over every registered wrapper (``engine/paged_model.PagedDecoder``
    replays them from CUDA graphs)."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each, in
    parallel. Returns the compiler's report (registers, shared memory,
    spills) per source it built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def current_stream(device: int) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device, for a
    kernel launch. ``torch.cuda.current_stream(d).cuda_stream`` gives the
    same handle but builds a Stream object first, several microseconds per
    call on a path that launches once per layer."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device)


def check(lib: ctypes.CDLL, prefix: str, err: int):
    """Raise if a kernel's C entry returned a CUDA error."""
    if err:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{prefix}: CUDA error {err}: "
                           f"{fn(err).decode()}")
