"""Build and load the hand-written CUDA kernels of the port.

Each `csrc/<name>.cu` exports plain C functions that take raw device
pointers and a stream and return a cudaError_t. It is compiled with
nvcc for sm_90a into a shared library under `build/kernels/` (keyed by
a hash of the source and flags, so an edited source rebuilds) at first
use, and loaded with ctypes. Nothing is compiled or loaded at import
time: the CPU tests import every module of the port.

`LAUNCHES` counts kernel launches per kernel name; each wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# extra nvcc flags per source. fused_chunk keeps every float multiply
# and add separately rounded (no FMA contraction) so that the candidate
# distances, radius test and tie-breaks equal the plain version's.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "first_valid_cols": [],
    "fused_chunk": ["-fmad=false"],
}

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return exe


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", *EXTRA_FLAGS[name], "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(
        [ARCH, *EXTRA_FLAGS[name]]).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Sequence[str] = tuple(EXTRA_FLAGS)) -> Dict[str, str]:
    """Compile every named source that has no library yet, one nvcc
    per source, all started together. Returns {name: library path}.
    Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: str(_lib_path(name)) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Sequence[int | None], device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` (None
    matches any size) on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
