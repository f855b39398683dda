"""Row compaction: the first-BP valid columns of each row.

Port of `pointnerf2studio_tpu/ops/select.py`. `first_valid_cols` is the
wrapper of the hand-written CUDA kernel `csrc/first_valid_cols.cu`
(replacing the Pallas kernel `_kernel`, ops/select.py:41 of the
reference): on a CUDA tensor it launches the kernel, on a CPU tensor it
runs the plain version `first_valid_cols_reference`, the expression the
reference's kernel replaces.

The kernel is bound by device-memory bytes (one read of qs, BP + 1
int32 written per row); see the source's header for its design.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pointnerf2studio_torch.ops import _cuda


def first_valid_cols_reference(qs: torch.Tensor, BP: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (col_sel [R, BP] int32 — the (b+1)-th valid column
    id ascending, D past the count; cnt_raw [R] int32)."""
    R, D = qs.shape
    mask = qs >= 0
    col = torch.arange(D, device=qs.device, dtype=torch.int32)
    key = torch.where(mask, col, torch.full_like(col, D))
    kk = min(BP, D)
    col_sel = torch.sort(key, dim=-1).values[:, :kk]
    if kk < BP:
        col_sel = torch.cat(
            [col_sel, col_sel.new_full((R, BP - kk), D)], -1)
    return col_sel.to(torch.int32), mask.sum(-1).to(torch.int32)


def first_valid_cols(qs: torch.Tensor, BP: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ids of the first BP valid (>= 0) entries of qs [R, D]
    int32. CUDA tensors launch the kernel; CPU tensors take the plain
    version. Returns (col_sel [R, BP] int32, cnt_raw [R] int32)."""
    if not qs.is_cuda:
        return first_valid_cols_reference(qs, BP)
    R, D = qs.shape
    _cuda.require(qs, "qs", torch.int32, (R, D), qs.device)
    if BP < 1:
        raise ValueError(f"BP must be >= 1, got {BP}")
    col_sel = torch.empty((R, BP), dtype=torch.int32, device=qs.device)
    cnt = torch.empty((R,), dtype=torch.int32, device=qs.device)
    lib = _cuda.library("first_valid_cols")
    fn = lib.first_valid_cols
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["first_valid_cols"] += 1
    _cuda.check(fn(_cuda.ptr(qs), _cuda.ptr(col_sel), _cuda.ptr(cnt),
                   R, D, BP, _cuda.stream_handle(qs.device)),
                "first_valid_cols launch")
    return col_sel, cnt


def select_first_cols(qs: torch.Tensor, BP: int, cap: int,
                      mode: str = "topk"):
    """First-BP valid column ids of qs [R, Dax], the per-row keep count
    clipped to `cap`, and the any-valid mask. mode="pallas" goes through
    `first_valid_cols` (the CUDA kernel on CUDA tensors); any other mode
    uses the plain version. Outputs are identical either way."""
    if mode == "pallas":
        col_sel, cnt_raw = first_valid_cols(qs, BP)
    else:
        col_sel, cnt_raw = first_valid_cols_reference(qs, BP)
    return col_sel, torch.clamp(cnt_raw, max=cap), cnt_raw > 0


def rank_gather_pack(qs: torch.Tensor, col_sel: torch.Tensor,
                     cnt: torch.Tensor, M: int):
    """Dense-pack each ray's first cnt[r] selected columns into M slots
    by inverting the offset cumsum (one integer histogram + cumsum, then
    [M]-row gathers). Slots past sum(cnt) are masked.

    Returns (sel_ray, sel_slot, colm, sel, qslot_c, mask_c), int64
    except mask_c (bool): packed ray id, per-ray slot index, selected
    column (clamped to Dax-1), flat (ray*Dax + col) id, gathered qs value
    (>= 0), and the valid-prefix mask over the M slots.
    """
    R, Dax = qs.shape
    BP = col_sel.shape[1]
    dev = qs.device
    cnt = cnt.long()
    off_end = torch.cumsum(cnt, 0)
    off = off_end - cnt
    inc = torch.zeros(M + 1, dtype=torch.long, device=dev).index_add_(
        0, torch.clamp(off_end, max=M), torch.ones_like(off_end))
    mi = torch.arange(M, device=dev)
    sel_ray = torch.clamp(torch.cumsum(inc, 0)[:M], max=R - 1)
    sel_slot = mi - off[sel_ray]
    colm = torch.clamp(
        col_sel.reshape(-1)[sel_ray * BP + torch.clamp(sel_slot, 0, BP - 1)]
        .long(), max=Dax - 1)
    sel = sel_ray * Dax + colm
    qslot_c = torch.clamp(qs.reshape(-1)[sel].long(), min=0)
    mask_c = mi < torch.clamp(off_end[-1], max=M)
    return sel_ray, sel_slot, colm, sel, qslot_c, mask_c
