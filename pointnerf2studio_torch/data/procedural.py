"""Procedural SDF chair (geometry and albedo only).

Port of `chair_sdf` and `_albedo` from
`pointnerf2studio_tpu/data/procedural.py`: seat slab, four legs,
backrest frame and slats, sized to the reference chair's crop ranges,
with per-part wood colours and a view-consistent texture.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _box(p, center, half):
    q = (torch.abs(p - torch.tensor(center, dtype=p.dtype, device=p.device))
         - torch.tensor(half, dtype=p.dtype, device=p.device))
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(q.max(-1).values, max=0.0)
    return outside + inside


def _cylinder_z(p, cx, cy, r, z0, z1):
    """Capped vertical cylinder."""
    dxy = torch.sqrt((p[..., 0] - cx) ** 2 + (p[..., 1] - cy) ** 2) - r
    dz = torch.maximum(z0 - p[..., 2], p[..., 2] - z1)
    q = torch.stack([dxy, dz], -1)
    return (torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
            + torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1))


def chair_sdf(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distance, part id) for the chair. Parts: 0 seat, 1 legs,
    2 backrest frame, 3 slats."""
    seat = _box(p, [0.0, 0.0, -0.05], [0.60, 0.60, 0.07])
    legs = torch.minimum(
        torch.minimum(_cylinder_z(p, -0.50, -0.50, 0.07, -1.0, -0.10),
                      _cylinder_z(p, -0.50, 0.50, 0.07, -1.0, -0.10)),
        torch.minimum(_cylinder_z(p, 0.50, -0.50, 0.07, -1.0, -0.10),
                      _cylinder_z(p, 0.50, 0.50, 0.07, -1.0, -0.10)))
    stiles = torch.minimum(
        _cylinder_z(p, -0.50, 0.55, 0.06, 0.0, 1.00),
        _cylinder_z(p, 0.50, 0.55, 0.06, 0.0, 1.00))
    rail = _box(p, [0.0, 0.55, 0.95], [0.55, 0.055, 0.09])
    frame = torch.minimum(stiles, rail)
    slats = torch.minimum(
        torch.minimum(_box(p, [-0.30, 0.55, 0.45], [0.075, 0.03, 0.42]),
                      _box(p, [0.0, 0.55, 0.45], [0.075, 0.03, 0.42])),
        _box(p, [0.30, 0.55, 0.45], [0.075, 0.03, 0.42]))
    stacked = torch.stack([seat, legs, frame, slats], -1)
    d, part = stacked.min(-1)
    return d, part


_PART_COLORS = np.array([
    [0.62, 0.36, 0.18],     # seat: wood
    [0.25, 0.22, 0.20],     # legs: dark
    [0.55, 0.30, 0.15],     # frame
    [0.70, 0.52, 0.28],     # slats: light wood
], np.float32)


def _albedo(p: torch.Tensor, part: torch.Tensor,
            style: str = "v1") -> torch.Tensor:
    """Per-part base colour times wood grain and fine detail."""
    base = torch.as_tensor(_PART_COLORS, device=p.device)[part]
    grain = 0.5 + 0.5 * torch.sin(23.0 * p[..., 0] + 17.0 * p[..., 2]
                                  + 3.0 * torch.sin(5.0 * p[..., 1]))
    if style == "v2":
        fine = (torch.sin(63.0 * p[..., 0]
                          + 2.0 * torch.sin(48.0 * p[..., 2]))
                * torch.sin(57.0 * p[..., 2] + 51.0 * p[..., 1]))
        speck = torch.sin(45.0 * p[..., 0] + 52.0 * p[..., 1]
                          + 41.0 * p[..., 2])
        tex = 0.85 + 0.22 * grain + 0.10 * fine + 0.06 * speck
    else:
        fine = (torch.sin(210.0 * p[..., 0]
                          + 2.0 * torch.sin(160.0 * p[..., 2]))
                * torch.sin(190.0 * p[..., 2] + 170.0 * p[..., 1]))
        speck = torch.sin(151.0 * p[..., 0] + 173.0 * p[..., 1]
                          + 137.0 * p[..., 2])
        tex = 0.85 + 0.22 * grain + 0.12 * fine + 0.08 * speck
    return torch.clamp(base * tex[..., None], 0.0, 1.0)
