"""Candidate selection of the staged fast render path in one pass.

Port of `pointnerf2studio_tpu/ops/fused_select.py`. Per shading slot:
d2 of every candidate from its bf16 relative xyz plus `center - locs`,
ok = valid & slot mask & (d2 <= radius2), layered shell eligibility
(shell s stays searchable while fewer than K candidates were accepted
in the shells below it), then the K smallest d2 with smallest-column
tie-break (`lax.top_k(-d2)`'s order) and their payload rows.

`fused_candidate_select` is the wrapper of the hand-written CUDA kernel
`csrc/fused_select.cu` (replacing the Pallas kernel `_select_kernel`,
ops/fused_select.py:60 of the reference). It serves K <= 32 neighbours
of C <= 256 candidates (`check_envelope`, on either device): the tuned
entry point at K <= 8 and C <= 64 (eight lanes a slot), the entry point
`fused_candidate_select_any` of the same source at every other width (16
or 32 lanes a slot; counted in `_cuda.LAUNCHES` under that name). On
CUDA tensors it launches the kernel; on CPU tensors it runs the plain
version
`fused_candidate_select_reference`, which mirrors the Pallas kernel op
for op. Unlike the reference, which consumes the XLA-gathered
`kmeta[qslot]` / `kpay[qslot]` block, both read the candidate rows
through `qslot` from the cache (`models/fast_render.py::FatCache`). The
wrapper takes the cache's tensors as the kernel reads them: kmeta
[max_q, C] int32, the candidate-major payload kcand [max_q, C, PK] bf16
(a chosen neighbour is 96 contiguous bytes) and the relative-xyz planes
kxyz [max_q, 3, C] bf16 for the distance pass. The plain version takes
the reference's logical layout kpay [max_q, PK, C], which is the view
`kcand.transpose(1, 2)`, and gathers its rows block by block; the kernel
reads kcand and kxyz in place.

Output: nsel [M, K, PK] **bfloat16** (the reference writes float32 and
its caller casts to bf16 at once; the payload is bf16 bits passed
through, so nothing is lost) and pnt_mask [M, K] bool. The payload of
unselected k-slots is zero; a slot whose mask is false gives zeros and
an all-false pnt_mask. The kernel is bound by device-memory bytes; its
source header says how.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointnerf2studio_torch.ops import _cuda

PK = 48                 # payload channels (PAYW = 44 padded to 48)
K_MAX, C_MAX = 32, 256  # the widths the selection kernels take
TUNED_K, TUNED_C = 8, 64   # the tuned entry point's


def check_envelope(K: int, C: int) -> None:
    """Raise NotImplementedError, on any device, for a selection the
    port's kernels do not take: K neighbours in 1..32 of C candidates in
    1..256 (K may exceed C: the selection finds the valid ones)."""
    if not (1 <= K <= K_MAX and 1 <= C <= C_MAX):
        raise NotImplementedError(
            f"the selection kernels take K <= {K_MAX} neighbours of C <= "
            f"{C_MAX} candidates, got K={K}, C={C}")


def tuned(K: int, C: int) -> bool:
    """Whether the tuned entry point (eight lanes a slot) serves K, C."""
    return K <= TUNED_K and C <= TUNED_C


def _select_block(meta, pay, cd0, mask, K, radius2, num_shells):
    """One block of B slots, the reference kernel's math op for op.
    meta [B, C] int32, pay [B, PK, C] bf16, cd0 [B, 3] f32, mask [B]
    bool -> (nsel [B, K, PK] bf16, pmask [B, K] bool)."""
    B, C = meta.shape
    dev = meta.device
    shell = meta & 3
    valid = (meta >= 0) & mask[:, None]
    dx = pay[:, 0, :].float() + cd0[:, 0][:, None]
    dy = pay[:, 1, :].float() + cd0[:, 1][:, None]
    dz = pay[:, 2, :].float() + cd0[:, 2][:, None]
    d2 = dx * dx + dy * dy + dz * dz
    ok = valid
    if radius2 > 0:
        ok = ok & (d2 <= radius2)
    if num_shells > 1:
        eligible = shell == 0
        before = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        for s in range(1, num_shells):
            before = before + (ok & (shell == s - 1)).sum(
                -1, keepdim=True, dtype=torch.int32)
            eligible = eligible | ((shell == s) & (before < K))
        ok = ok & eligible

    inf = torch.tensor(float("inf"), device=dev)
    key = torch.where(ok, d2, inf)
    col = torch.arange(C, device=dev).expand(B, C)
    nsel, pmask = [], []
    for _ in range(K):
        m = key.min(-1, keepdim=True).values
        first = torch.where(key == m, col, C).min(-1, keepdim=True).values
        pm = m[:, 0] < inf
        sel = (col == first) & pm[:, None]
        pv = torch.gather(pay, 2, torch.clamp(first, max=C - 1)[:, None, :]
                          .expand(B, PK, 1))[..., 0]
        nsel.append(torch.where(pm[:, None], pv, torch.zeros_like(pv)))
        pmask.append(pm)
        key = torch.where(sel, inf, key)
    return torch.stack(nsel, 1), torch.stack(pmask, 1)


@torch.no_grad()
def fused_candidate_select_reference(
    kmeta: torch.Tensor, kpay: torch.Tensor, qslot: torch.Tensor,
    cdelta0: torch.Tensor, mask: torch.Tensor, K: int, radius2: float,
    num_shells: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `fused_candidate_select`: gathers kmeta[qslot]
    and kpay[qslot] explicitly and runs the reference kernel's math in
    blocks of `_cuda.PLAIN_BLOCK` slots."""
    M = qslot.shape[0]
    dev = qslot.device
    if M == 0:
        return (torch.zeros((0, K, PK), dtype=torch.bfloat16, device=dev),
                torch.zeros((0, K), dtype=torch.bool, device=dev))
    outs = []
    for s in range(0, M, _cuda.PLAIN_BLOCK):
        b = slice(s, s + _cuda.PLAIN_BLOCK)
        q = qslot[b].long()
        outs.append(_select_block(kmeta[q], kpay[q], cdelta0[b].float(),
                                  mask[b], K, radius2, num_shells))
    return tuple(torch.cat(x) for x in zip(*outs))


def fused_candidate_select_plain(kmeta, kcand, kxyz, *rest):
    """The plain version behind the wrapper's signature: it reads the
    [max_q, PK, C] view of kcand and has no use for kxyz."""
    return fused_candidate_select_reference(kmeta, kcand.transpose(1, 2),
                                            *rest)


@torch.no_grad()
def fused_candidate_select(
    kmeta: torch.Tensor,        # [max_q, C] int32
    kcand: torch.Tensor,        # [max_q, C, PK] bf16, candidate-major
    kxyz: torch.Tensor,         # [max_q, 3, C] bf16, == kcand[:, :, :3].mT
    qslot: torch.Tensor,        # [M] int32 candidate row of each slot
    cdelta0: torch.Tensor,      # [M, 3] float32, center - locs
    mask: torch.Tensor,         # [M] bool
    K: int, radius2: float, num_shells: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nsel [M, K, PK] bf16, pnt_mask [M, K] bool) for all M slots.
    CUDA tensors launch the kernel; CPU tensors take the plain version on
    the [max_q, PK, C] view of kcand."""
    dev = kmeta.device
    max_q, C = kmeta.shape
    M = qslot.shape[0]
    _cuda.require(kmeta, "kmeta", torch.int32, (max_q, C), dev)
    _cuda.require(kcand, "kcand", torch.bfloat16, (max_q, C, PK), dev)
    _cuda.require(kxyz, "kxyz", torch.bfloat16, (max_q, 3, C), dev)
    check_envelope(K, C)
    if not kmeta.is_cuda:
        return fused_candidate_select_plain(
            kmeta, kcand, kxyz, qslot, cdelta0, mask, K, radius2, num_shells)
    _cuda.require(qslot, "qslot", torch.int32, (M,), dev)
    _cuda.require(cdelta0, "cdelta0", torch.float32, (M, 3), dev)
    _cuda.require(mask, "mask", torch.bool, (M,), dev)
    nsel = torch.empty((M, K, PK), dtype=torch.bfloat16, device=dev)
    pmask = torch.empty((M, K), dtype=torch.bool, device=dev)
    entry = ("fused_candidate_select" if tuned(K, C)
             else "fused_candidate_select_any")
    fn = getattr(_cuda.library("fused_select"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES[entry] += 1
    _cuda.check(fn(*[_cuda.ptr(t) for t in (
        kmeta, kcand, kxyz, qslot, cdelta0, mask, nsel, pmask)], M, C, K,
        float(radius2), int(num_shells), _cuda.stream_handle(dev)),
        f"{entry} launch")
    return nsel, pmask
