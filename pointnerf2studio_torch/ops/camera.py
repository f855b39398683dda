"""Camera-space ("perspective") coordinate transforms.

Port of `pointnerf2studio_tpu/ops/camera.py`: `w2pers` maps world points
to (x/z, y/z, z) with R_c2w^T (p - campos). Written as elementwise
multiply-adds in the reference's order, not as a matmul, so the
geometry keeps plain float32 arithmetic on every device.
"""

from __future__ import annotations

import torch


def world_to_cam(point_xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
                 campos: torch.Tensor) -> torch.Tensor:
    """World -> camera frame: R_c2w^T @ (p - campos). Any leading shape."""
    shift = point_xyz_w - campos
    return (shift[..., :, None] * camrotc2w).sum(-2)


def w2pers(point_xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """World -> perspective (x/z, y/z, z) coordinates, [..., 3]."""
    xyz_c = world_to_cam(point_xyz_w, camrotc2w, campos)
    z = xyz_c[..., 2]
    return torch.stack([xyz_c[..., 0] / z, xyz_c[..., 1] / z, z], -1)
