"""Camera-space ("perspective") coordinate transforms.

Port of `pointnerf2studio_tpu/ops/camera.py`: `w2pers` maps world points
to (x/z, y/z, z) with R_c2w^T (p - campos). Written as elementwise
multiply-adds in the reference's order, not as a matmul, so the
geometry keeps plain float32 arithmetic on every device. Also the
`gau_intrp` weight kernel's local frames (`roll_pitch_yaw_to_rotation`,
`world2local_dist`).
"""

from __future__ import annotations

import torch


def rotate(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """v @ rot for v [..., 3] and rot [3, 3], as elementwise
    multiply-adds."""
    return (v[..., :, None] * rot).sum(-2)


def world_to_cam(point_xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
                 campos: torch.Tensor) -> torch.Tensor:
    """World -> camera frame: R_c2w^T @ (p - campos). Any leading shape."""
    return rotate(point_xyz_w - campos, camrotc2w)


def w2pers(point_xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """World -> perspective (x/z, y/z, z) coordinates, [..., 3]."""
    xyz_c = world_to_cam(point_xyz_w, camrotc2w, campos)
    z = xyz_c[..., 2]
    return torch.stack([xyz_c[..., 0] / z, xyz_c[..., 1] / z, z], -1)


def neighbor_dists(neigh_xyz: torch.Tensor, locs: torch.Tensor,
                   camrotc2w: torch.Tensor, campos: torch.Tensor
                   ) -> torch.Tensor:
    """The decoder's per-neighbour offsets [M, K, 6] of neighbours
    neigh_xyz [M, K, 3] from shading points locs [M, 3]: the world delta,
    then the delta in perspective coordinates (x and y scaled back by
    depth)."""
    nei = w2pers(neigh_xyz, camrotc2w, campos)
    lp = w2pers(locs, camrotc2w, campos)[..., None, :]
    pdist = torch.stack(
        [nei[..., 0] * nei[..., 2] - lp[..., 0] * lp[..., 2],
         nei[..., 1] * nei[..., 2] - lp[..., 1] * lp[..., 2],
         nei[..., 2] - lp[..., 2]], -1)
    return torch.cat([neigh_xyz - locs[..., None, :], pdist], -1)


def roll_pitch_yaw_to_rotation(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] roll/pitch/yaw (radians, applied x then y then z) ->
    [..., 3, 3] rotation matrices (ZYX Euler composition)."""
    cx, cy, cz = (torch.cos(rpy[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(rpy[..., i]) for i in range(3))
    rows = torch.stack(
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
         sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
         -sy, cy * sx, cy * cx], -1)
    return rows.reshape(rpy.shape[:-1] + (3, 3))


def world2local_dist(dists: torch.Tensor, radii: torch.Tensor,
                     rotations: torch.Tensor) -> torch.Tensor:
    """Offsets dists [..., 3] rotated into per-point local frames
    (roll/pitch/yaw `rotations` [..., 3]) and scaled by 1 / radii [..., 3]:
    the anisotropic-gaussian footprint of the `gau_intrp` weight kernel.
    The rotation is elementwise multiply-adds, rot @ dists."""
    rot = roll_pitch_yaw_to_rotation(rotations)
    local = (rot * dists[..., None, :]).sum(-1)
    return local / (radii + 1e-8)
