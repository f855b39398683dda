"""The joint step's plane-sweep cost volume as one autograd Function.

`cost_volume` builds the [D, Hp, Wp, 3V + 32] volume of
`models/mvsnet/costvol.py::build_cost_volume` (the ref view's colour, each
source view's warped colour, the variance of the ref and warped source
features over the views whose sample lies inside the image) from the
source views' sample coordinates, and its backward to the features.

On CUDA tensors the forward and the backward are the hand-written kernels
of `csrc/costvol.cu` (`cost_volume_kernel`, `cost_volume_backward_kernel`;
no Pallas counterpart: the JAX package builds the volume from array ops).
On CPU tensors they are the plain versions `cost_volume_plain` and
`cost_volume_backward_plain`, the same arithmetic in torch.

- The forward equals the composite (`build_cost_volume_composite`: four
  `bilinear_grid_sample` taps a view, then the variance) bit for bit: the
  same operations in the same order.
- The backward reaches the features only. The images and the coordinates
  carry no gradient in the joint step, and the Function raises where they
  would need one. Each feature's gradient is a sum in a fixed order: the
  ref view's over the planes ascending; a source pixel's over the planes
  ascending, then the samples that tap it in raster order. So two runs
  give the same bits, and the kernel gives the plain version's. The
  composite's autograd sums the same terms in another order (torch's
  indexing backward) and rounds the variance's derivative as two terms,
  so it agrees within rounding.

The kernel's backward runs inside the span `costvol.backward`; autograd
launches it from its own thread, outside the caller's spans.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.utils import profiling

# feature channels (the FPN's) and the views a volume may have
FEAT_C = 32
MAX_VIEWS = 8

Grid = Tuple[torch.Tensor, torch.Tensor]


def _padded(t: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(t, (0, 0, pad, pad, pad, pad))


def _source_views(V: int, vid: int) -> List[int]:
    return [v for v in range(V) if v != vid]


def _in_frame(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)


def _taps(gx: torch.Tensor, gy: torch.Tensor, h: int, w: int):
    """Taps 00, 10, 01, 11 of the samples (gx, gy) in an h x w image, as
    `bilinear_grid_sample(align_corners=True)` rounds them: the clamped
    flat pixel id (int64), whether the tap lies inside (bool) and the
    weight, each a list of four tensors of gx's shape."""
    fx = (gx + 1.0) * 0.5 * (w - 1)
    fy = (gy + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    x0i, y0i = x0.long(), y0.long()
    ids, inside = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0i + dx, y0i + dy
        inside.append((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))
        ids.append(torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1))
    ax, ay = 1 - wx, 1 - wy
    return ids, inside, [ax * ay, wx * ay, ax * wy, wx * wy]


def _sample(table: torch.Tensor, taps) -> torch.Tensor:
    """table [h * w, C] at the taps: each tap's row times its inside flag
    times its weight, summed 00 + 10 + 01 + 11."""
    ids, inside, weights = taps
    out = None
    for i, m, wt in zip(ids, inside, weights):
        t = table[i] * m[..., None].to(table.dtype) * wt[..., None]
        out = t if out is None else out + t
    return out


def cost_volume_plain(feats: torch.Tensor, imgs_q: torch.Tensor,
                      grids: Sequence[Grid], vid: int = 0,
                      pad: int = 0) -> torch.Tensor:
    """Plain version of the forward: [D, Hp, Wp, 3V + 32]."""
    V, h, w, C = feats.shape
    D, Hp, Wp = grids[0][0].shape
    ref = _padded(feats[vid], pad)[None].expand(D, Hp, Wp, C)
    vol_sum, vol_sq = ref, ref * ref
    count = torch.ones((D, Hp, Wp), dtype=feats.dtype, device=feats.device)
    rgb = [_padded(imgs_q[vid], pad)[None].expand(D, Hp, Wp, 3)]
    for v, (gx, gy) in zip(_source_views(V, vid), grids):
        warped = _sample(torch.cat([feats[v], imgs_q[v]], -1).reshape(
            h * w, C + 3), _taps(gx, gy, h, w))
        wf = warped[..., :C]
        vol_sum = vol_sum + wf
        vol_sq = vol_sq + wf * wf
        rgb.append(warped[..., C:])
        count = count + _in_frame(gx, gy).to(feats.dtype)
    cnt = 1.0 / count[..., None]
    mean = vol_sum * cnt
    return torch.cat(rgb + [vol_sq * cnt - mean * mean], -1)


def cost_volume_backward_plain(g: torch.Tensor, feats: torch.Tensor,
                               grids: Sequence[Grid], vid: int = 0,
                               pad: int = 0) -> torch.Tensor:
    """Plain version of the backward: the gradient [V, h, w, 32] of the
    features under the volume's gradient g [D, Hp, Wp, 3V + 32], summed in
    the kernel's order (the module docstring): `index_add_` on the CPU
    adds its rows one after another in index order."""
    V, h, w, C = feats.shape
    D, Hp, Wp = grids[0][0].shape
    ref = _padded(feats[vid], pad)
    taps = [_taps(gx, gy, h, w) for gx, gy in grids]
    srcs = _source_views(V, vid)
    wfs = [_sample(feats[v].reshape(h * w, C), t) for v, t in zip(srcs, taps)]
    vol_sum = ref[None].expand(D, Hp, Wp, C)
    count = torch.ones((D, Hp, Wp), dtype=feats.dtype, device=feats.device)
    for wf, (gx, gy) in zip(wfs, grids):
        vol_sum = vol_sum + wf
        count = count + _in_frame(gx, gy).to(feats.dtype)
    cnt = 1.0 / count[..., None]
    mean = vol_sum * cnt
    gs = g[..., -C:] * (2.0 * cnt)
    grad = torch.empty_like(feats)
    g_ref = gs * (ref - mean)
    acc = torch.zeros_like(ref)
    for d in range(D):
        acc = acc + g_ref[d]
    grad[vid] = acc[pad:pad + h, pad:pad + w]
    for v, wf, (ids, inside, weights) in zip(srcs, wfs, taps):
        g_wf = gs * (wf - mean)
        # rows in (plane, pixel, tap) order
        rows = torch.stack([wt[..., None] * g_wf for wt in weights], -2)
        keep = torch.stack(inside, -1)
        grad[v] = torch.zeros((h * w, C), dtype=feats.dtype,
                              device=feats.device).index_add_(
            0, torch.stack(ids, -1)[keep], rows[keep]).view(h, w, C)
    return grad


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and on a 16-byte boundary (the kernels load float4s)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _pointers(tensors: Sequence[torch.Tensor]):
    """A ctypes array of the tensors' device pointers, and its address."""
    arr = (ctypes.c_void_p * max(len(tensors), 1))(
        *(t.data_ptr() for t in tensors))
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _checked_grids(grids: Sequence[Grid], D: int, Hp: int, Wp: int,
                   dev: torch.device) -> Tuple[list, list]:
    gxs, gys = [], []
    for gx, gy in grids:
        gx, gy = gx.contiguous(), gy.contiguous()
        _cuda.require(gx, "gx", torch.float32, (D, Hp, Wp), dev)
        _cuda.require(gy, "gy", torch.float32, (D, Hp, Wp), dev)
        gxs.append(gx)
        gys.append(gy)
    return gxs, gys


def cost_volume_kernel(feats: torch.Tensor, imgs_q: torch.Tensor,
                       grids: Sequence[Grid], vid: int = 0,
                       pad: int = 0) -> torch.Tensor:
    """The forward kernel on CUDA tensors: [D, Hp, Wp, 3V + 32]."""
    dev = feats.device
    V, h, w, C = feats.shape
    D, Hp, Wp = grids[0][0].shape
    feats = _aligned(feats)
    imgs_q = imgs_q.contiguous()
    _cuda.require(feats, "feats", torch.float32, (V, h, w, FEAT_C), dev)
    _cuda.require(imgs_q, "imgs_q", torch.float32, (V, h, w, 3), dev)
    gxs, gys = _checked_grids(grids, D, Hp, Wp, dev)
    out = torch.empty((D, Hp, Wp, 3 * V + FEAT_C), dtype=torch.float32,
                      device=dev)
    # the pointer arrays live until the launch has read them
    (arr_x, px), (arr_y, py) = _pointers(gxs), _pointers(gys)
    fn = _cuda.library("costvol").costvol_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["costvol_forward"] += 1
    _cuda.check(fn(_cuda.ptr(feats), _cuda.ptr(imgs_q), px, py,
                   _cuda.ptr(out), V, vid, h, w, pad, D,
                   _cuda.stream_handle(dev)), "costvol_forward launch")
    return out


def cost_volume_backward_kernel(g: torch.Tensor, feats: torch.Tensor,
                                grids: Sequence[Grid], vid: int = 0,
                                pad: int = 0) -> torch.Tensor:
    """The backward kernels on CUDA tensors: the features' gradient [V, h,
    w, 32]. g may have any strides."""
    dev = feats.device
    V, h, w, C = feats.shape
    D, Hp, Wp = grids[0][0].shape
    feats = _aligned(feats)
    _cuda.require(feats, "feats", torch.float32, (V, h, w, FEAT_C), dev)
    if g.dtype != torch.float32 or g.device != dev or tuple(g.shape) != (
            D, Hp, Wp, 3 * V + FEAT_C):
        raise ValueError(f"the volume's gradient is {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}, expected float32 "
                         f"{(D, Hp, Wp, 3 * V + FEAT_C)} on {dev}")
    gxs, gys = _checked_grids(grids, D, Hp, Wp, dev)
    S, K, Np = V - 1, (h + 1) * (w + 1), Hp * Wp
    work = torch.empty(S * D * (2 * K + 1 + Np), dtype=torch.int32,
                       device=dev)
    gwf = torch.empty((S, D, Np, FEAT_C), dtype=torch.float32, device=dev)
    grad = torch.empty_like(feats)
    (arr_x, px), (arr_y, py) = _pointers(gxs), _pointers(gys)
    fn = _cuda.library("costvol").costvol_backward
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["costvol_backward"] += 1
    _cuda.check(fn(_cuda.ptr(g), *g.stride(), _cuda.ptr(feats), px, py,
                   _cuda.ptr(work), _cuda.ptr(gwf), _cuda.ptr(grad), V, vid,
                   h, w, pad, D, _cuda.stream_handle(dev)),
                "costvol_backward launch")
    return grad


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, imgs_q, vid, pad, *coords):
        if any(ctx.needs_input_grad[1:]):
            raise ValueError("cost_volume: the images and the sample "
                             "coordinates (the projections) carry no "
                             "gradient; detach them")
        grids = list(zip(coords[0::2], coords[1::2]))
        ctx.vid, ctx.pad = vid, pad
        ctx.save_for_backward(feats, *coords)
        if feats.is_cuda:
            return cost_volume_kernel(feats, imgs_q, grids, vid, pad)
        return cost_volume_plain(feats, imgs_q, grids, vid, pad)

    @staticmethod
    def backward(ctx, g):
        feats, *coords = ctx.saved_tensors
        grids = list(zip(coords[0::2], coords[1::2]))
        with profiling.span("costvol.backward"):
            if g.is_cuda:
                grad = cost_volume_backward_kernel(g, feats, grids, ctx.vid,
                                                   ctx.pad)
            else:
                grad = cost_volume_backward_plain(g, feats, grids, ctx.vid,
                                                  ctx.pad)
        return (grad, None, None, None) + (None,) * len(coords)


def cost_volume(feats: torch.Tensor, imgs_q: torch.Tensor,
                grids: Sequence[Grid], vid: int = 0,
                pad: int = 0) -> torch.Tensor:
    """[D, h + 2 pad, w + 2 pad, 3V + 32] cost volume of features feats
    [V, h, w, 32] and images imgs_q [V, h, w, 3] with ref view `vid`;
    `grids` holds (gx, gy) [D, Hp, Wp], the normalised coordinates of each
    source view's samples (the views other than `vid`, ascending). V is 2
    to 8. Differentiable in feats only: raises where imgs_q or a
    coordinate requires a gradient."""
    V, h, w, C = feats.shape
    if C != FEAT_C or not 2 <= V <= MAX_VIEWS or not 0 <= vid < V or pad < 0:
        raise ValueError(f"cost_volume takes 2-{MAX_VIEWS} views of "
                         f"{FEAT_C} channels, 0 <= vid < V and pad >= 0; "
                         f"got feats {tuple(feats.shape)}, vid {vid}, "
                         f"pad {pad}")
    if tuple(imgs_q.shape) != (V, h, w, 3):
        raise ValueError(f"imgs_q has shape {tuple(imgs_q.shape)}, expected "
                         f"{(V, h, w, 3)}")
    if len(grids) != V - 1:
        raise ValueError(f"{len(grids)} coordinate grids for {V - 1} "
                         f"source views")
    D = grids[0][0].shape[0]
    for gx, gy in grids:
        if gx.shape != (D, h + 2 * pad, w + 2 * pad) or gy.shape != gx.shape:
            raise ValueError(f"coordinates of shape {tuple(gx.shape)} and "
                             f"{tuple(gy.shape)}, expected "
                             f"{(D, h + 2 * pad, w + 2 * pad)}")
    return _CostVolume.apply(feats, imgs_q, vid, pad,
                             *(t for pair in grids for t in pair))
