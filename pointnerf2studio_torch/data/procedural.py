"""Procedural NeRF-Synthetic-format dataset: the SDF chair.

Port of `pointnerf2studio_tpu/data/procedural.py`: a sphere-traced SDF
chair (seat slab, four legs, backrest frame and slats, sized to the
reference chair's crop ranges) with per-part wood colours, a
view-consistent texture and, in style "v2", a Blinn-Phong lobe, written
to a NeRF-Synthetic directory (transforms_{train,test}.json and RGBA
PNGs, the blender camera conventions) with optional ground-truth camera-Z
depth maps for the depth initialisation of the point cloud.

The sphere tracing is plain torch on the tensors' device: `render_view`,
`render_depth` and `generate_chair_dataset` run on the card unless given
`device="cpu"`. Camera rays are made with numpy as the reference makes
them. The reference runs the same loop jitted on XLA:CPU, which contracts
`origin + dirs * t` into a fused multiply-add; the port rounds the
product and the sum apart, so a ray's walk can differ from the
reference's in the last bits and, rarely, its hit mask with it.

What the scene allows: the JAX package's own record of style "v2" at
`ss=2` (VALIDATION_RESULTS.json, 64 train views of 400x400, initialised
from the ground-truth depth with 136,192 points) is 22.18 dB at step
2,504, 25.03 dB at 10,000 and 27.12 dB at 32,504, and a plateau near
27.5-27.6 dB after that: 30 dB was not reached.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from pointnerf2studio_torch.data.blender import BLENDER2OPENCV
from pointnerf2studio_torch.ops._cuda import resolve_device

CAMERA_ANGLE_X = 0.6911112070083618          # blender synthetic default
RADIUS = 4.0311289              # camera ring radius (blender synthetic)
# the sphere tracer: rays start at t = 2, stop past t = 6.5, hit where the
# distance falls under 1e-3, and step 0.9 of the distance (at least 1e-3)
T_START, T_STOP, HIT_EPS, STEP_FRAC = 2.0, 6.5, 1e-3, 0.9


def _box(p, center, half):
    # per axis with Python scalars: no host-to-device copy of the centre
    # and half sizes on each call (the same float32 arithmetic as
    # subtracting them as tensors)
    q = torch.stack([torch.abs(p[..., i] - center[i]) - half[i]
                     for i in range(3)], -1)
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


def _trace(origin: torch.Tensor, dirs: torch.Tensor, n_steps: int):
    """Sphere tracing of every ray: (t [N], hit [N] bool) after `n_steps`
    steps. The loop stops early once no ray is still marching (checked
    every 32 steps): from there no step changes t or hit."""
    t = torch.full((dirs.shape[0],), T_START, dtype=torch.float32,
                   device=dirs.device)
    hit = torch.zeros(dirs.shape[0], dtype=torch.bool, device=dirs.device)
    for k in range(n_steps):
        p = origin + dirs * t[:, None]
        d, _ = chair_sdf(p)
        hit = hit | ((~hit) & (d < HIT_EPS) & (t < T_STOP))
        alive = (~hit) & (t < T_STOP)
        t = torch.where(alive, t + torch.clamp(d, min=HIT_EPS) * STEP_FRAC,
                        t)
        if k % 32 == 31 and not bool(alive.any()):
            break
    return t, hit


def _camera_dirs(c2w_gl: np.ndarray, h: int, w: int, focal: float
                 ) -> np.ndarray:
    """Unit world ray directions [h * w, 3] of an OpenGL camera (-Z
    forward, +Y up) through pixel centres, in numpy as the reference."""
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    dirs_cam = np.stack(
        [(i + 0.5 - w / 2) / focal, -(j + 0.5 - h / 2) / focal,
         -np.ones_like(i, np.float32)], -1).astype(np.float32)
    dirs = dirs_cam @ c2w_gl[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.reshape(-1, 3).astype(np.float32)


def _march_depth(origin: torch.Tensor, dirs: torch.Tensor,
                 w2c_rot: torch.Tensor, w2c_t: torch.Tensor,
                 n_steps: int) -> torch.Tensor:
    """Camera-Z depth [N] (the ScanNet sensor-depth analogue; 0 where the
    ray misses)."""
    t, hit = _trace(origin, dirs, n_steps)
    p = origin + dirs * t[:, None]
    z = (p * w2c_rot[2]).sum(-1) + w2c_t[2]
    return torch.where(hit, z, 0.0)


def render_depth(c2w_gl: np.ndarray, hw: Tuple[int, int], focal: float,
                 n_steps: int = 200,
                 device: torch.device | str | None = None) -> np.ndarray:
    """Ground-truth camera-Z depth (OpenCV camera convention: +z forward)
    [H, W], traced on `device` (None: the card)."""
    device = resolve_device(device)
    H, W = hw
    dirs = _camera_dirs(c2w_gl, H, W, focal)
    origin = c2w_gl[:3, 3].astype(np.float32)
    # OpenCV w2c: flip y/z of the GL camera (BLENDER2OPENCV)
    w2c = np.linalg.inv(c2w_gl @ BLENDER2OPENCV)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    z = _march_depth(dev(origin), dev(dirs), dev(w2c[:3, :3]),
                     dev(w2c[:3, 3]), n_steps)
    return z.cpu().numpy().reshape(H, W)


def _unit(v) -> torch.Tensor:
    return v / torch.linalg.norm(v)


def _march_rays(origin: torch.Tensor, dirs: torch.Tensor, n_steps: int,
                style: str = "v1") -> torch.Tensor:
    """RGBA [N, 4] of every ray: the sphere-traced hit shaded by two
    directional lights over an ambient term. style="v2" adds a
    Blinn-Phong specular lobe, view-dependent but smooth in space and
    angle: the radiance a per-point MLP's view-direction branch can fit."""
    t, hit = _trace(origin, dirs, n_steps)
    ph = origin + dirs * t[:, None]
    _, part = chair_sdf(ph)
    eps = 2e-3
    n = torch.stack([
        chair_sdf(ph + torch.tensor(e, device=ph.device))[0]
        - chair_sdf(ph - torch.tensor(e, device=ph.device))[0]
        for e in ([eps, 0.0, 0.0], [0.0, eps, 0.0], [0.0, 0.0, eps])], -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-8)
    l1 = _unit(torch.tensor([0.5, -0.6, 0.62], device=ph.device))
    l2 = _unit(torch.tensor([-0.6, 0.4, 0.69], device=ph.device))
    diff = (0.65 * torch.clamp((n * l1).sum(-1), min=0.0)
            + 0.35 * torch.clamp((n * l2).sum(-1), min=0.0) + 0.25)
    rgb = _albedo(ph, part, style=style) * diff[:, None]
    if style == "v2":
        view = -dirs                                     # to the camera
        ks = torch.tensor([0.18, 0.30, 0.22, 0.15],
                          device=ph.device)[part]        # per-part gloss
        spec = torch.zeros_like(diff)
        for light in (l1, l2):
            h = light + view
            h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                                min=1e-8)
            spec = spec + torch.clamp((n * h).sum(-1), min=0.0) ** 24.0
        rgb = rgb + (ks * spec)[:, None]
    rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.cat([rgb, torch.ones_like(rgb[:, :1])], -1) * hit[:, None]


def render_view(c2w_gl: np.ndarray, hw: Tuple[int, int], focal: float,
                n_steps: int = 128, style: str = "v1", ss: int = 1,
                device: torch.device | str | None = None) -> np.ndarray:
    """Sphere-trace one view on `device` (None: the card) -> RGBA
    [H, W, 4] float32 in [0, 1].

    c2w_gl is the OpenGL-convention camera (blender transform_matrix):
    the camera looks along -Z, +Y up. `ss` > 1 traces ss x ss subpixel
    samples and box-downsamples them (on the host, as the reference), the
    anti-aliasing real blender renders have."""
    device = resolve_device(device)
    H, W = hw
    Hs, Ws, fs = H * ss, W * ss, focal * ss
    dirs = _camera_dirs(c2w_gl, Hs, Ws, fs)
    origin = c2w_gl[:3, 3].astype(np.float32)
    rgba = _march_rays(torch.as_tensor(origin, device=device),
                       torch.as_tensor(dirs, device=device), n_steps,
                       style).cpu().numpy().reshape(Hs, Ws, 4)
    if ss > 1:
        rgba = rgba.reshape(H, ss, W, ss, 4).mean((1, 3))
    return rgba


def spherical_c2w_gl(theta: float, phi: float,
                     radius: float = RADIUS) -> np.ndarray:
    """Blender-convention c2w looking at the origin (z-up world)."""
    pos = radius * np.array([
        np.cos(phi) * np.sin(theta), -np.cos(phi) * np.cos(theta),
        np.sin(phi)], np.float32)
    back = pos / np.linalg.norm(pos)              # +Z_cam (OpenGL)
    up_w = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(up_w, back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, back, pos
    return m


def chair_cameras(n_train: int, n_test: int, seed: int = 0):
    """{"train": [c2w_gl, ...], "test": [...]}: train views at azimuths
    uniform on the circle and elevations uniform in [5, 55] degrees from
    `np.random.default_rng(seed)`, test views on a ring at 30 degrees."""
    rng = np.random.default_rng(seed)
    out = {"train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        for k in range(n):
            if split == "train":
                theta = float(rng.uniform(-np.pi, np.pi))
                phi = float(rng.uniform(np.deg2rad(5), np.deg2rad(55)))
            else:
                theta = -np.pi + 2 * np.pi * k / n
                phi = np.deg2rad(30.0)
            out[split].append(spherical_c2w_gl(theta, phi))
    return out


def chair_focal(width: int) -> float:
    return 0.5 * width / np.tan(0.5 * CAMERA_ANGLE_X)


def generate_chair_dataset(out_dir: str, n_train: int = 32,
                           n_test: int = 8, hw: Tuple[int, int] = (400, 400),
                           seed: int = 0, save_depth: bool = False,
                           style: str = "v1", ss: int = 1,
                           device: torch.device | str | None = None) -> str:
    """Write a NeRF-Synthetic-format chair dataset, traced on `device`
    (None: the card); returns out_dir.

    With `save_depth`, train views also get `depth_<k>.npy` ground-truth
    camera-Z maps (the ScanNet sensor-depth analogue, read by the depth
    initialisation). style="v2" with ss=2 is the band-limited, specular,
    anti-aliased variant (module docstring: what PSNR it allows). PIL is
    imported here."""
    from PIL import Image

    device = resolve_device(device)
    H, W = hw
    focal = chair_focal(W)
    for split, cams in chair_cameras(n_train, n_test, seed).items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for k, c2w in enumerate(cams):
            rgba = render_view(c2w, hw, focal, style=style, ss=ss,
                               device=device)
            img8 = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
            name = f"./{split}/r_{k}"
            Image.fromarray(img8, "RGBA").save(
                os.path.join(out_dir, f"{name[2:]}.png"))
            if save_depth and split == "train":
                np.save(os.path.join(out_dir, split, f"depth_{k}.npy"),
                        render_depth(c2w, hw, focal,
                                     device=device).astype(np.float32))
            frames.append({"file_path": name,
                           "rotation": 0.0,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X,
                       "frames": frames}, f)
    return out_dir


if __name__ == "__main__":
    import sys

    # python -m pointnerf2studio_torch.data.procedural OUT [N_TRAIN] [RES]
    #     [depth] [v2] [cpu]
    out = sys.argv[1] if len(sys.argv) > 1 else "proc_chair"
    n_train = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    res = int(sys.argv[3]) if len(sys.argv) > 3 else 400
    flags = sys.argv[4:]
    style = "v2" if "v2" in flags else "v1"
    generate_chair_dataset(out, n_train=n_train, hw=(res, res),
                           save_depth="depth" in flags, style=style,
                           ss=2 if style == "v2" else 1,
                           device="cpu" if "cpu" in flags else None)
    print("wrote", out, style)
