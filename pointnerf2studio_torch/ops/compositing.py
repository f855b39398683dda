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
    z_g = grid(z_m, 0.0)
    sig_g = grid(sig, 0.0)
    rgb_g = grid(rgb, 0.0)
    zmask = torch.where(ok_g, z_g, torch.full_like(z_g, -1e9))
    dist = ray_dist_from_sample_z(zmask, ok_g, vsize_z)
    opacity = 1.0 - torch.exp(-sig_g * dist)
    trans = torch.cumprod(1.0 - opacity + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    blend = BLEND_FUNCTIONS[blend_func](opacity, trans)
    rgb_sum = (blend[..., None] * rgb_g).sum(-2)
    acc = blend.sum(-1)
    depth = (blend * z_g).sum(-1)
    return rgb_sum, acc, depth, ok_g.any(-1)
