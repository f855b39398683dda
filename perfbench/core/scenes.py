"""The benchmark's scene makers: frozen copies, taken so that the inputs
are the benchmark's own and the reference takes nothing the program made.

- `chair_sdf`, `_box`, `_cylinder_z`, `_albedo` (style "v1") and
  `chair_points` copy `pointnerf2studio_torch/data/procedural.py` and the
  point half of `data/synthetic.py::make_chair_scene` (its cloud arrays,
  without the grid and the weights);
- `ring_pose` copies `chip_smoke.py::orbit_pose` with the elevation as an
  argument;
- `camera_rays` copies `data/synthetic.py::camera_rays` on numpy;
- `room_cloud` and `room_pose` copy `chip_smoke.py::make_room_cloud` and
  `room_pose` (the reference's `tools/stress_scannet_scale.py:50-153`).

`perfbench/tests/test_perfbench_frozen.py` holds each copy equal to its
original as it was when copied. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

RING_RADIUS = 4.0311289


def _box(p, center, half):
    q = torch.stack([torch.abs(p[..., i] - center[i]) - half[i]
                     for i in range(3)], -1)
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(q.max(-1).values, max=0.0)
    return outside + inside


def _cylinder_z(p, cx, cy, r, z0, z1):
    dxy = torch.sqrt((p[..., 0] - cx) ** 2 + (p[..., 1] - cy) ** 2) - r
    dz = torch.maximum(z0 - p[..., 2], p[..., 2] - z1)
    q = torch.stack([dxy, dz], -1)
    return (torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
            + torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1))


def chair_sdf(p: torch.Tensor):
    """(distance, part id) of the procedural chair: 0 seat, 1 legs,
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
    d, part = torch.stack([seat, legs, frame, slats], -1).min(-1)
    return d, part


_PART_COLORS = np.array([
    [0.62, 0.36, 0.18],
    [0.25, 0.22, 0.20],
    [0.55, 0.30, 0.15],
    [0.70, 0.52, 0.28],
], np.float32)


def _albedo(p: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    base = torch.as_tensor(_PART_COLORS, device=p.device)[part]
    grain = 0.5 + 0.5 * torch.sin(23.0 * p[..., 0] + 17.0 * p[..., 2]
                                  + 3.0 * torch.sin(5.0 * p[..., 1]))
    fine = (torch.sin(210.0 * p[..., 0] + 2.0 * torch.sin(160.0 * p[..., 2]))
            * torch.sin(190.0 * p[..., 2] + 170.0 * p[..., 1]))
    speck = torch.sin(151.0 * p[..., 0] + 173.0 * p[..., 1]
                      + 137.0 * p[..., 2])
    tex = 0.85 + 0.22 * grain + 0.12 * fine + 0.08 * speck
    return torch.clamp(base * tex[..., None], 0.0, 1.0)


def _project_to_chair(p: torch.Tensor):
    """4 Newton steps along the numerical SDF gradient."""
    eps = 1e-4
    g = torch.zeros_like(p)
    for _ in range(4):
        d = chair_sdf(p)[0]
        cols = []
        for ax in range(3):
            e = torch.zeros(3, device=p.device)
            e[ax] = eps
            cols.append(chair_sdf(p + e)[0] - chair_sdf(p - e)[0])
        g = torch.stack(cols, -1) / (2 * eps)
        g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                            min=1e-6)
        p = p - d[:, None] * g
    return p, chair_sdf(p)[0], g


def chair_points(n_points: int, seed: int, scaled_vsize_z: float,
                 jitter_sigma_voxels: float, device) -> dict:
    """The procedural chair's cloud as numpy arrays (xyz, emb, conf, dir,
    color): points on the SDF surface, jittered by `jitter_sigma_voxels`
    scaled voxels, random 0.1-scale embeddings, confidence 0.8."""
    rng = np.random.default_rng(seed)
    lo = np.array([-0.72, -0.70, -1.00], np.float32)
    hi = np.array([0.66, 0.71, 1.05], np.float32)
    pts_l, col_l, dir_l = [], [], []
    have = 0
    while have < n_points:
        cand = rng.uniform(lo, hi, (2 * n_points, 3)).astype(np.float32)
        p, d, g = _project_to_chair(torch.as_tensor(cand, device=device))
        keep = torch.abs(d) < 1e-3
        p, g = p[keep], g[keep]
        _, part = chair_sdf(p)
        pts_l.append(p.cpu().numpy())
        col_l.append(_albedo(p, part).cpu().numpy())
        dir_l.append(g.cpu().numpy())
        have += p.shape[0]
    pts = np.concatenate(pts_l)[:n_points]
    colors = np.concatenate(col_l)[:n_points].clip(0, 1)
    dirs = np.concatenate(dir_l)[:n_points]
    dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-6)
    pts = pts + rng.normal(0, jitter_sigma_voxels * scaled_vsize_z,
                           pts.shape).astype(np.float32)
    emb = rng.standard_normal((n_points, 32)).astype(np.float32) * 0.1
    conf = np.full((n_points, 1), 0.8, np.float32)
    return dict(xyz=pts.astype(np.float32), emb=emb, conf=conf,
                dir=dirs.astype(np.float32), color=colors.astype(np.float32))


def ring_pose(az_deg: float, el_deg: float = 30.0,
              radius: float = RING_RADIUS) -> np.ndarray:
    """c2w [4, 4] (opencv axes) of a camera on the NeRF-Synthetic ring at
    azimuth `az_deg`, `el_deg` above the horizon, looking at the origin."""
    el, az = np.deg2rad(el_deg), np.deg2rad(az_deg)
    campos = radius * np.array([np.cos(el) * np.sin(az),
                                -np.cos(el) * np.cos(az), np.sin(el)])
    fwd = -campos / np.linalg.norm(campos)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], -1)
    pose[:3, 3] = campos
    return pose


def camera_rays(camrotc2w: np.ndarray, height: int, width: int,
                focal: float) -> np.ndarray:
    """Normalised world ray directions [H*W, 3] float32 of a pinhole
    camera, row-major pixels."""
    i, j = np.meshgrid(np.arange(width), np.arange(height))
    x = (i + 0.5 - width / 2) / focal
    y = (j + 0.5 - height / 2) / focal
    d = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rot = np.asarray(camrotc2w, np.float32)
    return (d @ rot.T).astype(np.float32)


def room_cloud(n_points: int, seed: int) -> dict:
    """The ScanNet-scale stress room: points on the walls, floor and
    ceiling of a 6 x 6 x 3 m room and on 24 furniture boxes, 2 mm noise;
    numpy arrays (xyz, emb, conf, dir, color)."""
    rng = np.random.default_rng(seed)
    hx = hy = hz = 3.0
    n_wall = int(n_points * 0.75)
    n_blob = n_points - n_wall
    faces, areas = [], []
    for z in (0.0, hz):
        faces.append(("z", z))
        areas.append(4 * hx * hy)
    for x in (-hx, hx):
        faces.append(("x", x))
        areas.append(2 * hy * hz)
    for y in (-hy, hy):
        faces.append(("y", y))
        areas.append(2 * hx * hz)
    areas = np.asarray(areas) / np.sum(areas)
    counts = rng.multinomial(n_wall, areas)
    pts = []
    for (axis, v), c in zip(faces, counts):
        u = rng.uniform(-1, 1, (c, 2))
        if axis == "z":
            p = np.stack([u[:, 0] * hx, u[:, 1] * hy, np.full(c, v)], -1)
        elif axis == "x":
            p = np.stack([np.full(c, v), u[:, 0] * hy,
                          (u[:, 1] * 0.5 + 0.5) * hz], -1)
        else:
            p = np.stack([u[:, 0] * hx, np.full(c, v),
                          (u[:, 1] * 0.5 + 0.5) * hz], -1)
        pts.append(p)
    per = n_blob // 24
    for _ in range(24):
        c = rng.uniform([-2.5, -2.5, 0.1], [2.5, 2.5, 1.2])
        half = rng.uniform(0.15, 0.6, 3)
        face = rng.integers(0, 3, per)
        sgn = rng.choice([-1.0, 1.0], per)
        u = rng.uniform(-1, 1, (per, 3)) * half
        p = c + u
        p[np.arange(per), face] = c[face] + sgn * half[face]
        pts.append(p)
    xyz = np.concatenate(pts, 0)[:n_points].astype(np.float32)
    n = xyz.shape[0]
    xyz += rng.normal(0, 0.002, xyz.shape).astype(np.float32)
    colors = (np.abs(np.sin(xyz * 3.0)) * 0.8 + 0.1).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    emb = (rng.standard_normal((n, 32)) * 0.1).astype(np.float32)
    conf = np.full((n, 1), 0.8, np.float32)
    return dict(xyz=xyz, emb=emb, conf=conf, dir=dirs, color=colors)


def room_pose(az_deg: float, back: float = 1.2,
              height: float = 1.4) -> np.ndarray:
    """c2w [4, 4] of a level camera in the room looking at azimuth
    `az_deg` (0: along +y), `back` metres behind the room's centre at
    `height`."""
    az = np.deg2rad(az_deg)
    fwd = np.array([np.sin(az), np.cos(az), 0.0])
    right = np.array([np.cos(az), -np.sin(az), 0.0])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], -1)
    pose[:3, 3] = np.array([0.0, 0.0, height]) - back * fwd
    return pose
