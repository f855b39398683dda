"""Stratified ray sample generation.

Port of `pointnerf2studio_tpu/ops/raygen.py`: uniform (or
disparity-linear, or linear then disparity-linear past a middle plane)
[near, far] segments, each optionally jittered by a +-jitter/2 fraction
of its own length, sample positions at the segment midpoints; and the
inverse-CDF importance resampling (`sample_pdf`) with its refinement
pass (`refine_ray_generation`).

The jitter draws are supplied by the caller (`jitter_u`, uniform [0, 1)
per sample). The reference draws them from a JAX key through the rbg
generator, which torch cannot reproduce; the port's train step draws its
own from a `torch.Generator` on the device (`jitter_uniform`), and a
parity test hands both packages the same numbers. Without `jitter_u`
the closed form runs, as it does in the reference when no key is given.
`sample_pdf` takes its uniforms the same way (`u`, or a generator).
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


def _march_from_segments(campos, raydir, seg, near):
    """Segment lengths [B, R, D] -> (raypos, seg * |raydir|, mid_ts), by
    the running sum of the segments from `near`."""
    B, R, D = seg.shape
    end_ts = near + torch.cumsum(seg, -1)
    start = torch.as_tensor(near, dtype=seg.dtype, device=seg.device)
    end_ts = torch.cat([start.expand(B, R, 1), end_ts], -1)
    mid_ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    raypos = (campos[:, None, None, :]
              + raydir[:, :, None, :] * mid_ts[..., None])
    return raypos, seg * torch.linalg.norm(raydir, dim=-1)[..., None], mid_ts


def near_middle_far_ray_generation(
    campos: torch.Tensor, raydir: torch.Tensor, num_samples: int,
    near, middle, far, middle_split: float = 0.6, jitter: float = 0.0,
    jitter_u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Samples linear in t over [near, middle] (the first middle_split of
    them) and linear in disparity over [middle, far]; same returns as
    `near_far_linear_ray_generation`. Positions always come from the
    running sum of the segments, as in the reference."""
    squeeze = raydir.ndim == 2
    if squeeze:
        raydir = raydir[None]
        campos = campos[None] if campos.ndim == 1 else campos
    B, R, _ = raydir.shape
    dtype, dev = raydir.dtype, raydir.device
    n0 = int(num_samples * middle_split) + 1
    t0 = _unit_steps(n0, dtype, dev)
    vals0 = near * (1.0 - t0) + middle * t0
    n1 = num_samples - n0 + 2
    t1 = _unit_steps(n1, dtype, dev)
    vals1 = 1.0 / (1.0 / middle * (1.0 - t1) + 1.0 / far * t1)
    tvals = torch.cat([vals0, vals1])
    base_seg = (tvals[1:] - tvals[:-1])[:num_samples]
    if jitter > 0.0 and jitter_u is not None:
        u = jitter_u.reshape(B, R, num_samples).to(dtype)
        seg = base_seg * (1.0 + jitter * (u - 0.5))
    else:
        seg = base_seg.expand(B, R, num_samples)
    out = _march_from_segments(campos, raydir, seg, near)
    return tuple(x[0] for x in out) if squeeze else out


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = True, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF importance resampling of ray ts: bins [..., S] (the
    previous sample ts) weighted by `weights` [..., S]; returns the new
    ts merged with the old bins and sorted, [..., n_samples + S], with no
    gradient. The uniforms are evenly spaced under `det` (or with neither
    `u` nor `generator`), else `u` [..., n_samples] or draws from
    `generator`."""
    mids = 0.5 * (bins[..., 1:] + bins[..., :-1])
    w = weights[..., 1:-1] + 1e-5
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (n_samples,)
    if det or (u is None and generator is None):
        u = _unit_steps(n_samples, bins.dtype, bins.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, dtype=bins.dtype,
                       device=generator.device).to(bins.device)
    u = u.to(bins.dtype).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = mids.shape[-1] - 1
    bin_b = torch.gather(mids, -1, torch.clamp(below, max=last))
    bin_a = torch.gather(mids, -1, torch.clamp(above, max=last))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a),
                        cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    samples = bin_b + t * (bin_a - bin_b)
    merged = torch.cat([samples, bins.detach()], -1)
    return torch.sort(merged, -1).values.detach()


def refine_ray_generation(
    campos: torch.Tensor, raydir: torch.Tensor, num_samples: int,
    prev_ts: torch.Tensor, prev_weights: torch.Tensor, jitter: float = 0.0,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The importance refinement pass: `sample_pdf` over the previous
    pass's ts [..., R, S] and weights, its first num_samples + 1 merged
    ts taken as segment ends; same returns as
    `near_far_linear_ray_generation`. Deterministic uniforms unless
    jitter > 0, then `u` [..., R, num_samples + 1] or `generator`."""
    squeeze = raydir.ndim == 2
    if squeeze:
        raydir = raydir[None]
        campos = campos[None] if campos.ndim == 1 else campos
        prev_ts, prev_weights = prev_ts[None], prev_weights[None]
        u = None if u is None else u[None]
    end_ts = sample_pdf(prev_ts, prev_weights, num_samples + 1,
                        det=jitter <= 0, u=u, generator=generator)
    end_ts = end_ts[..., :num_samples + 1]
    seg = end_ts[..., 1:] - end_ts[..., :-1]
    mid_ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    raypos = (campos[:, None, None, :]
              + raydir[:, :, None, :] * mid_ts[..., None])
    seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    if squeeze:
        return raypos[0], seg[0], mid_ts[0]
    return raypos, seg, mid_ts
