"""Volumetric alpha compositing.

Port of `pointnerf2studio_tpu/ops/compositing.py`: per-slot step length
from the running max of camera-space z, opacity 1 - exp(-sigma * dist),
exclusive transmittance cumprod(1 - opacity + 1e-10), blend sums plus
(1 - acc) * background.

`packed_alpha_composite` takes the packed [M] slot layout of the fast
path. Each ray's slots are contiguous, depth-ordered and at most
`max_slots` long, so instead of segmented scans over [M] the slots
scatter to an [R, max_slots] grid (empty cells act as the reference's
z = -1e9 holes) and the scans run per row with `cummax`/`cumprod`. The
result equals the segmented scans up to the f32 reduction tree.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ray_dist_from_sample_z(sample_z: torch.Tensor, ray_valid: torch.Tensor,
                           vsize_z: float) -> torch.Tensor:
    """Per-slot step lengths with the reference's cummax/clamp semantics."""
    zmax = torch.cummax(sample_z, dim=-1).values
    dist = torch.cat(
        [zmax[..., 1:] - zmax[..., :-1],
         torch.full(zmax.shape[:-1] + (1,), vsize_z, dtype=zmax.dtype,
                    device=zmax.device)], -1)
    degenerate = (dist < 1e-8) | (dist > 2.0 * vsize_z)
    dist = torch.where(degenerate, torch.full_like(dist, vsize_z), dist)
    return dist * ray_valid.to(dist.dtype)


def alpha_composite(sigma: torch.Tensor, rgb: torch.Tensor,
                    dist: torch.Tensor, background: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite sigma [..., SR] (already masked), rgb [..., SR, 3] and
    step lengths dist [..., SR] over `background` [3]: (colour [..., 3],
    acc [...])."""
    opacity = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(1.0 - opacity + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    blend = opacity * trans
    acc = blend.sum(-1)
    color = (blend[..., None] * rgb).sum(-2) + (1.0 - acc)[..., None] \
        * background
    return color, acc


def radiance_render(ray_feature: torch.Tensor) -> torch.Tensor:
    """The colour channels 1:4 of a decoded per-slot feature."""
    return ray_feature[..., 1:4]


def white_color(ray_feature: torch.Tensor) -> torch.Tensor:
    """All-white albedo (silhouette renders)."""
    return torch.ones_like(ray_feature[..., 1:4])


def segment_sums_contiguous(vals: torch.Tensor, off: torch.Tensor,
                            cnt: torch.Tensor, width: int) -> torch.Tensor:
    """Per-segment sums of vals [P, L] over contiguous runs
    [off[s], off[s] + cnt[s]) of at most `width` rows: `width` row
    gathers added in the run's order, so each segment's sum restarts at
    zero (no global running sum to cancel) and no write collides (no
    atomics): the order of the sums is fixed on every device."""
    P = vals.shape[0]
    out = vals.new_zeros((off.shape[0],) + vals.shape[1:])
    for r in range(width):
        row = vals[torch.clamp(off + r, max=max(P - 1, 0))]
        on = (cnt > r).reshape((-1,) + (1,) * (vals.ndim - 1))
        out = out + torch.where(on, row, torch.zeros_like(row))
    return out


def alpha_blend(opacity: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    return opacity * trans


def alpha2_blend(opacity: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    return opacity * trans * trans


def simple_tone_map(color: torch.Tensor, gamma: float = 2.2,
                    exposure: float = 1.0) -> torch.Tensor:
    return torch.clamp(torch.pow(color * exposure + 1e-5, 1.0 / gamma),
                       0.0, 1.0)


def normalize_tone_map(color: torch.Tensor) -> torch.Tensor:
    n = color / torch.clamp(torch.linalg.norm(color, dim=-1, keepdim=True),
                            min=1e-12)
    return n * 0.5 + 0.5


def no_tone_map(color: torch.Tensor) -> torch.Tensor:
    return color


BLEND_FUNCTIONS = {"alpha": alpha_blend, "alpha2": alpha2_blend}
RENDER_FUNCTIONS = {"radiance": radiance_render, "white": white_color}
TONE_MAPS = {"gamma": simple_tone_map, "normalize": normalize_tone_map,
             "off": no_tone_map}


def packed_alpha_composite(
    sig: torch.Tensor,          # [M] density, already zeroed on !slot_ok
    rgb: torch.Tensor,          # [M, 3]
    z_m: torch.Tensor,          # [M] camera-space z of shading locations
    slot_ok: torch.Tensor,      # [M] bool slot validity
    sel_ray: torch.Tensor,      # [M] owning ray (segments contiguous)
    pack_end: torch.Tensor,     # [R] exclusive segment end offsets
    pack_cnt: torch.Tensor,     # [R] per-ray slot counts (<= max_slots)
    vsize_z: float,
    blend_func: str,
    max_slots: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha-composite the packed [M] slot axis per ray.

    Returns (rgb_sum [R, 3], acc [R], depth [R], ray_found [R]).
    Slots at or past pack_end[-1] (the padding tail) contribute nothing.
    """
    M = sig.shape[0]
    R = pack_end.shape[0]
    BP = max_slots
    dev = sig.device
    mi = torch.arange(M, device=dev)
    off = (pack_end - pack_cnt).long()
    live = mi < pack_end[-1].clamp(max=M)
    slot = mi - off[sel_ray.long()]
    dest = torch.where(live, sel_ray.long() * BP + slot, R * BP)

    def grid(x, fill):
        g = torch.full((R * BP + 1,) + x.shape[1:], fill, dtype=x.dtype,
                       device=dev)
        g[dest] = x
        return g[:R * BP].reshape((R, BP) + x.shape[1:])

    ok_g = grid(slot_ok, False)
    rgb_sum, acc, depth, _ = composite_rows(
        grid(sig, 0.0), grid(rgb, 0.0), grid(z_m, 0.0), ok_g, vsize_z,
        blend_func)
    return rgb_sum, acc, depth, ok_g.any(-1)


def composite_rows(sig: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor,
                   valid: torch.Tensor, vsize_z: float, blend_func: str
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Alpha-composite each row of an [R, S] slot grid (sig [R, S], rgb
    [R, S, 3], camera-space z [R, S]; cells off `valid` are the
    reference's z = -1e9 holes): (rgb_sum [R, 3], acc [R], depth [R],
    opacity [R, S]). Differentiable."""
    zmask = torch.where(valid, z, torch.full_like(z, -1e9))
    dist = ray_dist_from_sample_z(zmask, valid, vsize_z)
    opacity = 1.0 - torch.exp(-sig * dist)
    trans = torch.cumprod(1.0 - opacity + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    blend = BLEND_FUNCTIONS[blend_func](opacity, trans)
    return ((blend[..., None] * rgb).sum(-2), blend.sum(-1),
            (blend * z).sum(-1), opacity)
