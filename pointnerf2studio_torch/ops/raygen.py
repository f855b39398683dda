"""Stratified ray sample generation.

Port of `near_far_linear_ray_generation` and
`near_far_disparity_linear_ray_generation` from
`pointnerf2studio_tpu/ops/raygen.py`: uniform (or disparity-linear)
[near, far] segments, each optionally jittered by a +-jitter/2 fraction
of its own length, sample positions at the segment midpoints.

The jitter draws are supplied by the caller (`jitter_u`, uniform [0, 1)
per sample). The reference draws them from a JAX key through the rbg
generator, which torch cannot reproduce; the port's train step draws its
own from a `torch.Generator` on the device (`jitter_uniform`), and a
parity test hands both packages the same numbers. Without `jitter_u`
the closed form runs, as it does in the reference when no key is given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def jitter_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform [0, 1) float32 draws of `shape` from `generator`, on the
    generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device)


def _unit_steps(num: int, dtype, device) -> torch.Tensor:
    """The values of the reference's linspace(0, 1, num): i times the
    rounded reciprocal of num - 1, which is what XLA compiles its
    division by a constant into, and 1 at the end (torch.linspace
    instead mirrors the upper half onto the lower)."""
    inv = torch.tensor(1.0 / (num - 1), dtype=dtype, device=device)
    t = torch.arange(num, dtype=dtype, device=device) * inv
    t[-1] = 1.0
    return t


def _generate(tvals, campos, raydir, near, jitter, jitter_u):
    squeeze = raydir.ndim == 2
    if squeeze:
        raydir = raydir[None]
        campos = campos[None] if campos.ndim == 1 else campos
    B, R, _ = raydir.shape
    D = tvals.shape[0] - 1
    dtype = raydir.dtype
    base_seg = tvals[1:] - tvals[:-1]                               # [D]
    if jitter > 0.0 and jitter_u is not None:
        u = jitter_u.reshape(B, R, D).to(dtype)
        seg = base_seg * (1.0 + jitter * (u - 0.5))
        end_ts = near + torch.cumsum(seg, -1)                       # [B, R, D]
        start = torch.as_tensor(near, dtype=dtype, device=raydir.device)
        end_ts = torch.cat([start.expand(B, R, 1), end_ts], -1)
        mid_ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    else:
        # closed form: the segments are the unjittered constants
        seg = base_seg.expand(B, R, D)
        mid_ts = (0.5 * (tvals[:-1] + tvals[1:])).expand(B, R, D)
    raypos = (campos[:, None, None, :]
              + raydir[:, :, None, :] * mid_ts[..., None])
    seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    if squeeze:
        return raypos[0], seg[0], mid_ts[0]
    return raypos, seg, mid_ts


def near_far_linear_ray_generation(
    campos: torch.Tensor,   # [3] or [B, 3]
    raydir: torch.Tensor,   # [R, 3] or [B, R, 3], normalised
    num_samples: int,
    near, far,
    jitter: float = 0.0,
    jitter_u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray world-space sample positions, linear in t.

    Returns raypos [..., R, D, 3], seg_len [..., R, D] (jittered segment
    lengths scaled by |raydir|) and mid_ts [..., R, D] (distance along
    the ray of each sample), D = num_samples."""
    t = _unit_steps(num_samples + 1, raydir.dtype, raydir.device)
    tvals = near * (1.0 - t) + far * t
    return _generate(tvals, campos, raydir, near, jitter, jitter_u)


def near_far_disparity_linear_ray_generation(
    campos: torch.Tensor, raydir: torch.Tensor, num_samples: int,
    near, far, jitter: float = 0.0,
    jitter_u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Samples linear in disparity (1/t), the `inverse` placement; same
    returns as `near_far_linear_ray_generation`."""
    t = _unit_steps(num_samples + 1, raydir.dtype, raydir.device)
    tvals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return _generate(tvals, campos, raydir, near, jitter, jitter_u)
