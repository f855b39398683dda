"""Synthetic scenes for tests, smoke runs and benchmarks.

Port of `pointnerf2studio_tpu/data/synthetic.py` (sphere_config,
make_sphere_scene, make_chair_scene, camera_rays). Point data comes
from a numpy generator seeded by `seed`; the aggregator weights come
from `Aggregator(cfg.agg, seed)`. Everything is built on `device`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pointnerf2studio_torch.config import PointNerfConfig, QueryConfig
from pointnerf2studio_torch.data.procedural import _albedo, chair_sdf
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.neural_points import (
    NeuralPointCloud, from_arrays)
from pointnerf2studio_torch.ops.grid import PointGrid, build_grid_from_points


@dataclasses.dataclass
class Scene:
    cfg: PointNerfConfig
    cloud: NeuralPointCloud
    grid: PointGrid
    params: Aggregator
    campos: torch.Tensor       # [3]
    camrotc2w: torch.Tensor    # [3, 3]
    near: float
    far: float


def sphere_config(sr: int = 24, k: int = 8, d: int = 120) -> PointNerfConfig:
    return PointNerfConfig(query=QueryConfig(
        vsize=(0.02, 0.02, 0.02), vscale=(2, 2, 2),
        SR=sr, K=k, P=12, max_o=200_000, z_depth_dim=d))


def _scene_params(cfg: PointNerfConfig, seed: int, device) -> Aggregator:
    agg = Aggregator(cfg.agg, seed=seed, device=device)
    # random init leaves the single ReLU density head ~all-negative;
    # bias it up so renders have visible content without training
    with torch.no_grad():
        agg.density_head[0].bias += 5.0
    return agg


def make_sphere_scene(n_points: int = 20_000, seed: int = 0,
                      cfg: PointNerfConfig | None = None,
                      device: torch.device | str = "cpu") -> Scene:
    """Coloured sphere shell of radius 0.5, camera at (0, 0, 2)."""
    rng = np.random.default_rng(seed)
    cfg = cfg or sphere_config()
    pts = rng.standard_normal((n_points, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= 0.5
    colors = (pts + 0.5).clip(0, 1)
    dirs = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    emb = rng.standard_normal((n_points, 32)).astype(np.float32) * 0.1
    conf = np.full((n_points, 1), 0.8, np.float32)
    cloud = from_arrays(pts, emb, conf, dirs, colors, device=device)
    grid = build_grid_from_points(cloud.xyz, cloud.alive, cfg.query)
    return Scene(
        cfg=cfg, cloud=cloud, grid=grid,
        params=_scene_params(cfg, seed, device),
        campos=torch.tensor([0.0, 0.0, 2.0], device=device),
        camrotc2w=torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                               device=device),
        near=1.0, far=3.0)


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


def make_chair_scene(n_points: int = 558_000, seed: int = 0,
                     cfg: PointNerfConfig | None = None,
                     jitter_sigma_voxels: float = 0.5,
                     device: torch.device | str = "cpu") -> Scene:
    """Chair-shaped scene at NeRF-Synthetic chair geometry: points on
    the procedural SDF chair surface, jittered by `jitter_sigma_voxels`
    scaled voxels; camera on the blender ring (radius 4.031, azimuth
    and elevation 30 degrees) looking at the origin; near/far [2, 6]."""
    rng = np.random.default_rng(seed)
    cfg = cfg or sphere_config()
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
    sv = float(cfg.query.vsize[2] * cfg.query.vscale[2])
    pts = pts + rng.normal(0, jitter_sigma_voxels * sv,
                           pts.shape).astype(np.float32)
    emb = rng.standard_normal((n_points, 32)).astype(np.float32) * 0.1
    conf = np.full((n_points, 1), 0.8, np.float32)
    cloud = from_arrays(pts.astype(np.float32), emb, conf,
                        dirs.astype(np.float32), colors.astype(np.float32),
                        device=device)
    grid = build_grid_from_points(cloud.xyz, cloud.alive, cfg.query)

    # blender-ring camera, opencv axes: x right, y down, z forward
    radius = 4.0311289
    az, el = np.deg2rad(30.0), np.deg2rad(30.0)
    campos = radius * np.array([np.cos(el) * np.sin(az),
                                -np.cos(el) * np.cos(az),
                                np.sin(el)], np.float32)
    fwd = -campos / np.linalg.norm(campos)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    camrotc2w = np.stack([right, down, fwd], -1).astype(np.float32)
    return Scene(
        cfg=cfg, cloud=cloud, grid=grid,
        params=_scene_params(cfg, seed, device),
        campos=torch.as_tensor(campos, device=device),
        camrotc2w=torch.as_tensor(camrotc2w, device=device),
        near=2.0, far=6.0)


def camera_rays(camrotc2w: torch.Tensor, height: int, width: int,
                focal: float) -> torch.Tensor:
    """Normalised world-space ray directions [H*W, 3] for a pinhole
    camera (row-major pixels), on camrotc2w's device."""
    i, j = np.meshgrid(np.arange(width), np.arange(height))
    x = (i + 0.5 - width / 2) / focal
    y = (j + 0.5 - height / 2) / focal
    d = np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rot = camrotc2w.detach().cpu().numpy()
    return torch.as_tensor((d @ rot.T).astype(np.float32),
                           device=camrotc2w.device)
