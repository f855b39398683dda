"""Build and load the hand-written CUDA kernels of the port.

Each `csrc/<name>.cu` exports plain C functions that take raw device
pointers and a stream and return a cudaError_t. It is compiled with
nvcc for sm_90a into a shared library under `build/kernels/` (keyed by
a hash of the source, of every header under `csrc/` and of the flags,
so an edited source or header rebuilds) at first use, and loaded with
ctypes. Nothing is compiled or loaded at import
time: the CPU tests import every module of the port. A source can also
be built with flags added (`variant`): a library of its own under the
same keying, which the wrappers launch inside the `with` block.

`LAUNCHES` counts kernel launches per kernel name; each wrapper adds
one where it launches its kernel and nowhere else. While a profiler
records (utils/profiling.py), nvcc's builds are the span `kernels.build`
and `kernels.builds`, `kernels.loads` and `kernels.weight_packs` (a
`packed_once` that packs) count.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import torch

from pointnerf2studio_torch.utils import profiling

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# extra nvcc flags per source. fused_chunk and fused_select keep every
# float multiply and add separately rounded (no FMA contraction) so that
# the candidate distances, radius test and tie-breaks equal the plain
# version's; fused_decode does so to round its biases, activations and
# weighted sums as its plain version does; march does so because the
# render path recomputes each emitted sample's position and voxel with
# separately rounded torch ops, and a sample on a voxel face must fall to
# the same side in both. decode_any and chunk_any, the generic-width
# sources, do so for fused_decode's and fused_chunk's reasons.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "first_valid_cols": [],
    "fused_chunk": ["-fmad=false"],
    "fused_select": ["-fmad=false"],
    "fused_decode": ["-fmad=false"],
    "decode_any": ["-fmad=false"],
    "chunk_any": ["-fmad=false"],
    "march": ["-fmad=false"],
}

# slots per step of the plain versions (bounds their memory)
PLAIN_BLOCK = 16384

LAUNCHES: collections.Counter = collections.Counter()
# a source, or a source and the flags added to its build
Spec = Union[str, Tuple[str, Sequence[str]]]
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_VARIANT: Dict[str, Tuple[str, ...]] = {}


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point builds on: the card unless the caller
    names another. With no card, `device=None` raises; it does not fall
    back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return exe


def _command(name: str, out: Path, csrc: Path = CSRC,
             extra: Sequence[str] = ()) -> List[str]:
    return [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", f"-I{csrc}", *EXTRA_FLAGS[name], *extra, "-o", str(out),
            str(csrc / f"{name}.cu")]


def _lib_path(name: str, csrc: Path = CSRC,
              extra: Sequence[str] = ()) -> Path:
    """Where the library of `csrc/<name>.cu` goes: keyed by the source,
    every header beside it (a source may include any of them) and the
    flags, those added by the caller included."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join([ARCH, *EXTRA_FLAGS[name], *extra]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _spec(spec: Spec) -> Tuple[str, Tuple[str, ...]]:
    return (spec, ()) if isinstance(spec, str) else (spec[0], tuple(spec[1]))


def packed_once(module, slot: str, params, make):
    """`make()`, kept on `module` under `slot` and made again only when
    one of `params` was moved or written in place (`data_ptr` and
    `_version` of each are the key)."""
    key = tuple((p.data_ptr(), p._version) for p in params)
    cached = module.__dict__.get(slot)
    if cached is not None and cached[0] == key:
        return cached[1]
    profiling.count("kernels.weight_packs")
    value = make()
    module.__dict__[slot] = (key, value)
    return value


def build(specs: Sequence[Spec] = tuple(EXTRA_FLAGS)) -> Dict[Spec, str]:
    """Compile every named source (or (source, added flags) pair) that
    has no library yet, one nvcc each, all started together. Returns
    {spec: library path}, a pair's flags as a tuple. Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    specs = [s if isinstance(s, str) else _spec(s) for s in specs]
    paths = {spec: _lib_path(_spec(spec)[0], extra=_spec(spec)[1])
             for spec in specs}
    todo = [spec for spec, path in paths.items() if not path.exists()]
    errors = []
    if todo:
        profiling.count("kernels.builds", len(todo))
        with profiling.span("kernels.build", "source=" + ",".join(
                _spec(spec)[0] for spec in todo)):
            procs = {}
            for spec in todo:
                name, extra = _spec(spec)
                tmp = paths[spec].with_suffix(f".{os.getpid()}.tmp")
                procs[spec] = (subprocess.Popen(
                    _command(name, tmp, extra=extra), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True), tmp, paths[spec])
            for spec, (proc, tmp, path) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for {spec}:\n{log}")
                else:
                    os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {spec: str(path) for spec, path in paths.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use; inside
    a `variant(name, flags)` block, the one built with those flags."""
    key = (name, _VARIANT.get(name, ()))
    lib = _LIBS.get(key)
    if lib is None:
        profiling.count("kernels.loads")
        lib = ctypes.CDLL(build([key])[key])
        _LIBS[key] = lib
    return lib


@contextlib.contextmanager
def variant(name: str, extra_flags: Sequence[str]):
    """Inside the block, `library(name)` - and so the wrappers of that
    source's kernels - is `csrc/<name>.cu` built with `extra_flags` added
    (a `-D` probe build, say)."""
    before = _VARIANT.get(name)
    _VARIANT[name] = tuple(extra_flags)
    try:
        yield
    finally:
        if before is None:
            del _VARIANT[name]
        else:
            _VARIANT[name] = before


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
