"""Plane background model (`PointNerfConfig.bgmodel = "plane"`).

Port of `pointnerf2studio_tpu/models/bg_plane.py` (reference:
pointnerf/models/mvs_points_volumetric_model.py:272-310 `set_bg` and
pointnerf/models/mvs/mvs_utils.py:299-427): every ray meets a
user-given plane; the meeting point is projected into every source view
and that view's colour sampled there (bilinear, zero padding,
align_corners); a sample is rejected where the projection lands on a
foreground pixel (one covered by a projected neural point) or where its
colour is off the plane colour by more than a threshold; the per-ray
maximum over views is the ray's background colour, which the renderers
take as `bg_ray_colors` in place of the constant `bg_color`.

Kept as the reference has them: the one-sided parallel test
`dot >= epsilon` and the `ceil` pixel indexing of the foreground mask
and of its lookup. The foreground mask's `.at[].max` is a
`scatter_reduce(..., "amax")`, whose result does not depend on order.
`bilinear_grid_sample` is the port's own copy of the reference's
(models/mvsnet/layers.py), written tap by tap as there and not with
F.grid_sample, whose edge handling and rounding differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.ops._cuda import resolve_device


def bilinear_grid_sample(img: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear sampling with zero padding for an [H, W, C] image at
    normalised coordinates grid [..., 2] in [-1, 1] (x, the width axis,
    first) -> [..., C]: four taps, each outside the image contributing
    zero."""
    H, W, _ = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = x0.long()
    y0i = y0.long()

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return v * inb[..., None].to(img.dtype)

    return (tap(x0i, y0i) * ((1 - wx) * (1 - wy))[..., None]
            + tap(x0i + 1, y0i) * (wx * (1 - wy))[..., None]
            + tap(x0i, y0i + 1) * ((1 - wx) * wy)[..., None]
            + tap(x0i + 1, y0i + 1) * (wx * wy)[..., None])


def ray_plane_intersection(campos: torch.Tensor, raydirs: torch.Tensor,
                           plane_pnt: torch.Tensor,
                           plane_normal: torch.Tensor,
                           epsilon: float = 1e-3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World point where each ray [R, 3] meets the plane, and whether it
    does: rays with dot(normal, dir) < epsilon (parallel, or facing the
    normal's other side) give zeros and False."""
    dot = (plane_normal * raydirs).sum(-1)                      # [R]
    valid = dot >= epsilon
    w = campos - plane_pnt
    fac = -(plane_normal * w).sum(-1) / torch.where(valid, dot, 1.0)
    pts = campos + raydirs * fac[..., None]
    return torch.where(valid[..., None], pts, 0.0), valid


def project_points(xyz_w: torch.Tensor, w2c: torch.Tensor,
                   intrinsic: torch.Tensor, hw: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords (x, y) [N, 2] of world points [N, 3] in a view, and
    whether each lies in the image and in front of the camera."""
    H, W = hw
    ones = torch.ones_like(xyz_w[..., :1])
    cam = torch.cat([xyz_w, ones], -1) @ w2c.T                  # [N, 4]
    z = torch.where(cam[..., 2:3].abs() < 1e-8,
                    torch.full_like(cam[..., 2:3], 1e-8), cam[..., 2:3])
    uv = (cam[..., :3] / z) @ intrinsic.T
    xy = uv[..., :2]
    inb = ((xy[..., 0] >= 0) & (xy[..., 0] <= W - 1)
           & (xy[..., 1] >= 0) & (xy[..., 1] <= H - 1)
           & (cam[..., 2] > 0))
    return xy, inb


def _ceil_pixel(xy: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Flat pixel index of the ceil of each projection, clamped."""
    H, W = hw
    xi = torch.clamp(torch.ceil(xy[..., 0]).long(), 0, W - 1)
    yi = torch.clamp(torch.ceil(xy[..., 1]).long(), 0, H - 1)
    return yi * W + xi


def fg_pixel_mask(points_xyz: torch.Tensor, w2c: torch.Tensor,
                  intrinsic: torch.Tensor, hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """[H, W] float mask of the pixels covered by projected foreground
    points (each at the ceil of its projection)."""
    H, W = hw
    xy, inb = project_points(points_xyz, w2c, intrinsic, hw)
    mask = torch.zeros(H * W, dtype=torch.float32, device=xy.device)
    mask.scatter_reduce_(0, _ceil_pixel(xy, hw), inb.float(), "amax")
    return mask.reshape(H, W)


def plane_background_colors(
        campos: torch.Tensor, raydirs: torch.Tensor, plane_pnt: torch.Tensor,
        plane_normal: torch.Tensor, plane_color: torch.Tensor,
        images: torch.Tensor, w2cs: torch.Tensor, intrinsics: torch.Tensor,
        points_xyz: Optional[torch.Tensor] = None,
        fg_masks: Optional[torch.Tensor] = None, thresh: float = 0.03
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bg colour [R, 3], valid [R]) of rays [R, 3] from the plane model
    over source views images [V, H, W, 3], w2cs [V, 4, 4], intrinsics
    [V, 3, 3]: per view the colour at the projected plane point, zero
    where it falls on foreground (`fg_masks` [V, H, W], or the masks of
    `points_xyz`), off the image or off the plane colour by more than
    `thresh`; then the maximum over views. Invalid rays keep zeros."""
    V, H, W, _ = images.shape
    sect, sect_ok = ray_plane_intersection(campos, raydirs, plane_pnt,
                                           plane_normal)
    if fg_masks is None:
        fg_masks = (torch.stack([fg_pixel_mask(points_xyz, w2cs[v],
                                               intrinsics[v], (H, W))
                                 for v in range(V)])
                    if points_xyz is not None else
                    torch.zeros((V, H, W), device=images.device))
    cols = []
    for v in range(V):
        xy, inb = project_points(sect, w2cs[v], intrinsics[v], (H, W))
        grid = torch.stack([xy[..., 0] / ((W - 1.0) / 2.0) - 1.0,
                            xy[..., 1] / ((H - 1.0) / 2.0) - 1.0], -1)
        col = bilinear_grid_sample(images[v], grid, align_corners=True)
        on_fg = fg_masks[v].reshape(-1)[_ceil_pixel(xy, (H, W))] >= 1.0
        ok = inb & ~on_fg & sect_ok
        fits = ((col >= plane_color - thresh)
                & (col <= plane_color + thresh)).all(-1)
        cols.append(col * (ok & fits)[..., None].to(col.dtype))
    cols = torch.stack(cols)                                    # [V, R, 3]
    bg = cols.max(0).values
    valid = (cols.sum(-1) > 0).any(0) & sect_ok
    return bg, valid


@torch.no_grad()
def create_all_bg(cfg, dataset, points_xyz=None, chunk: int = 16384,
                  views=None, src_dataset=None,
                  device: torch.device | str | None = None) -> np.ndarray:
    """Per-view background maps [V, H, W, 3] (numpy) of `dataset`'s rays
    (the reference's create_all_bg, train_ft.py:604-612), computed on
    `device` (None: the card; raises without one) in chunks of `chunk`
    rays. Colours are sampled from `src_dataset` (default `dataset`: pass
    the train split for test poses); `points_xyz` [N, 3] masks the
    foreground. Rays no view agrees on, or that miss the plane, take
    cfg.bg_color. Views not in `views` keep cfg.bg_color."""
    device = resolve_device(device)
    f32 = torch.float32
    src = src_dataset if src_dataset is not None else dataset
    V, VS = dataset.num_views, src.num_views
    H, W = dataset.hw
    Hs, Ws = src.hw
    views = list(range(V)) if views is None else views

    def dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    images = dev(src.images)
    w2cs = dev(np.linalg.inv(src.poses))
    intr = dev(np.broadcast_to(np.asarray(src.intrinsics), (VS, 3, 3)))
    plane_pnt = dev(cfg.bg_plane_pnt)
    plane_normal = dev(cfg.bg_plane_normal)
    plane_color = dev(cfg.bg_plane_color)
    const_bg = np.asarray(cfg.bg_color, np.float32)
    if points_xyz is not None:
        pts = torch.as_tensor(points_xyz, dtype=f32, device=device)
        fg_masks = torch.stack([fg_pixel_mask(pts, w2cs[v], intr[v],
                                              (Hs, Ws)) for v in range(VS)])
    else:
        fg_masks = torch.zeros((VS, Hs, Ws), dtype=f32, device=device)

    maps = np.broadcast_to(const_bg, (V, H, W, 3)).copy()
    for v in views:
        rays = dev(dataset.full_image_rays(v))
        campos = dev(dataset.campos(v))
        bg_v, ok_v = [], []
        for i in range(0, rays.shape[0], chunk):
            b, ok = plane_background_colors(
                campos, rays[i:i + chunk], plane_pnt, plane_normal,
                plane_color, images, w2cs, intr, fg_masks=fg_masks)
            bg_v.append(b)
            ok_v.append(ok)
        bg_v = torch.cat(bg_v).cpu().numpy().reshape(H, W, 3)
        ok_v = torch.cat(ok_v).cpu().numpy().reshape(H, W)
        maps[v] = np.where(ok_v[..., None], bg_v, const_bg)
    return maps
