"""Full-image evaluation and video rendering.

Port of `pointnerf2studio_tpu/train/evaluator.py` (the reference's
`test()` loop, pointnerf/run/train_ft.py:252-414 and
run/evaluate.py:34-97: chunked full-frame render, stitch, metrics; the
video path of run/render_vid.py). Three renderers, each taking rays on
the device:

  * `make_render_chunk_fn`: the legacy `render_rays`, one chunk size;
  * `make_fast_chunk_fn`: `fast_render_rays` on a fat cache built once
    (the depth window sized to the grid box when it is negative);
  * `make_fast_frame_renderer`: `render_frame` on that cache, with the
    raster front-end for a march config (`raster=`). `render_frame`
    takes the raster only where it serves the frame and reports the
    front-end it used; it catches nothing else.

`render_video` imports imageio and `save_images` PIL where they are
used. The hash grid and the plane background are not ported (ROADMAP
queue 1 item 9); asking for them raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.data.blender import BlenderDataset, pixel_raydirs
from pointnerf2studio_torch.models.fast_render import (
    make_fast_scene, render_frame, suggest_depth_window, fast_render_rays)
from pointnerf2studio_torch.models.render import render_rays
from pointnerf2studio_torch.utils import metrics as M


def _unported(cfg: PointNerfConfig) -> None:
    if cfg.query.grid_mode == "hash" or cfg.bgmodel.endswith("plane"):
        raise NotImplementedError(
            "evaluation with the hash grid or the plane background is not "
            "ported (ROADMAP queue 1 item 9)")


def make_render_chunk_fn(cfg: PointNerfConfig):
    """A chunk renderer through the legacy `render_rays`:
    fn(params, points, grid, campos, camrotc2w, raydirs, near, far)
    -> (colour, ray_mask, depth, acc)."""
    _unported(cfg)

    @torch.no_grad()
    def fn(params, points, grid, campos, camrotc2w, raydirs, near, far):
        out = render_rays(params, points, grid, campos, camrotc2w, raydirs,
                          near, far, cfg)
        return out.coarse_raycolor, out.ray_mask, out.depth, out.acc

    return fn


def make_fast_chunk_fn(cfg: PointNerfConfig, points, grid, near: float,
                       far: float):
    """A chunk renderer through `fast_render_rays` on a fat cache built
    here once (the points and grid arguments of each call are ignored).
    A negative depth_window becomes the grid box's chord bound. The first
    chunk's dw / rb overflow counters are read and a non-zero one is
    reported."""
    _unported(cfg)
    if cfg.query.depth_window < 0:
        dw = suggest_depth_window(grid.dims, cfg.query.scaled_vsize, near,
                                  far, cfg.query.z_depth_dim)
        cfg = dataclasses.replace(cfg, query=dataclasses.replace(
            cfg.query, depth_window=dw))
    cache, rmin, svs = make_fast_scene(cfg, points, grid)
    Rw2c = points.Rw2c
    checked: List[int] = []

    def fn(params, _points, _grid, campos, camrotc2w, raydirs, near, far):
        out = fast_render_rays(params, Rw2c, cache, campos, camrotc2w,
                               raydirs, near, far, cfg, rmin, svs)
        if not checked:
            checked.append(1)
            for name, knob in (("dw_overflow", "depth_window"),
                               ("rb_overflow", "ray_budget")):
                v = getattr(out, name)
                if v is not None and int(v) > 0:
                    print(f"WARNING: {name} = {int(v)} on the first chunk — "
                          f"results are NOT exact; raise QueryConfig."
                          f"{knob}")
        return out.coarse_raycolor, out.ray_mask, out.depth, out.acc

    return fn


def make_fast_frame_renderer(cfg: PointNerfConfig, points, grid, near: float,
                             far: float, chunk: int = 65536,
                             tier_quant: int = 32, raster=None):
    """A full-frame renderer through `render_frame` on a fat cache built
    here once: render(params, campos, camrotc2w, raydirs) ->
    FastRenderOutput. depth_window and ray_budget are render_frame's to
    set per chunk; the raster programs are kept across frames. The first
    frame's dw_overflow is read and a non-zero one reported."""
    _unported(cfg)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, depth_window=0, ray_budget=0))
    cache, rmin, svs = make_fast_scene(cfg, points, grid)
    Rw2c = points.Rw2c
    programs: Dict = {}
    warned: List[int] = []

    def render(params, campos, camrotc2w, raydirs):
        dev = points.xyz.device
        out = render_frame(
            params, Rw2c, cache,
            torch.as_tensor(campos, dtype=torch.float32, device=dev),
            torch.as_tensor(camrotc2w, dtype=torch.float32, device=dev),
            torch.as_tensor(raydirs, dtype=torch.float32, device=dev),
            near, far, cfg, rmin, svs, chunk=chunk, tier_quant=tier_quant,
            program_cache=programs, raster=raster,
            host_rays=raydirs if isinstance(raydirs, np.ndarray) else None)
        if out.dw_overflow is not None and not warned:
            warned.append(1)
            if int(out.dw_overflow) > 0:
                print(f"WARNING: frame depth-window tiers dropped "
                      f"{int(out.dw_overflow)} in-box samples on the first "
                      f"frame — results are NOT exact")
        return out

    return render


def render_image(render_chunk, params, points, grid, campos, camrotc2w,
                 raydirs: np.ndarray, hw, near: float, far: float,
                 chunk: int) -> Dict[str, np.ndarray]:
    """Chunked full-frame render -> stitched H x W canvases (numpy)."""
    dev = points.xyz.device
    h, w = hw
    total = h * w
    rays = torch.as_tensor(np.asarray(raydirs, np.float32), device=dev)
    campos = torch.as_tensor(np.asarray(campos, np.float32), device=dev)
    camrot = torch.as_tensor(np.asarray(camrotc2w, np.float32), device=dev)
    outs = [render_chunk(params, points, grid, campos, camrot,
                         rays[i:i + chunk], near, far)
            for i in range(0, total, chunk)]
    c, m, d, a = (torch.cat(x).cpu().numpy() for x in zip(*outs))
    return {"coarse_raycolor": c.reshape(h, w, 3), "ray_mask": m.reshape(h, w),
            "depth": d.reshape(h, w), "acc": a.reshape(h, w)}


def evaluate_dataset(cfg: PointNerfConfig, params, points, grid,
                     dataset: BlenderDataset,
                     views: Optional[List[int]] = None, chunk: int = 4096,
                     out_dir: Optional[str] = None,
                     save_images: bool = False, fast: bool = False,
                     frame: bool = True) -> Dict[str, float]:
    """Mean PSNR / SSIM / RMSE over `views` (default all) of `dataset`
    (the reference's report_metrics). `fast` renders through the fat-cache
    path: with `frame` through `render_frame` (the raster front-end for a
    march config), else chunk by chunk; otherwise through the legacy
    `render_rays`. `save_images` writes eval_<view>.png into `out_dir`."""
    _unported(cfg)
    frame_render = render_chunk = None
    if fast and frame:
        raster = None
        if cfg.query.march_steps:
            k = np.asarray(dataset.intrinsics)
            h, w = dataset.hw
            raster = (h, w, (float(k[0, 0]), float(k[1, 1]),
                             float(k[0, 2]), float(k[1, 2])))
        frame_render = make_fast_frame_renderer(
            cfg, points, grid, dataset.near, dataset.far, chunk=chunk,
            raster=raster)
    elif fast:
        render_chunk = make_fast_chunk_fn(cfg, points, grid, dataset.near,
                                          dataset.far)
    else:
        render_chunk = make_render_chunk_fn(cfg)
    views = views if views is not None else list(range(dataset.num_views))
    per: Dict[str, List[float]] = {}
    h, w = dataset.hw
    for v in views:
        rays = dataset.full_image_rays(v)
        if frame_render is not None:
            o = frame_render(params, dataset.campos(v), dataset.camrotc2w(v),
                             rays)
            img = o.coarse_raycolor.cpu().numpy().reshape(h, w, 3)
        else:
            img = render_image(render_chunk, params, points, grid,
                               dataset.campos(v), dataset.camrotc2w(v), rays,
                               dataset.hw, dataset.near, dataset.far,
                               chunk)["coarse_raycolor"]
        for k, val in M.compute_all(img, dataset.images[v]).items():
            per.setdefault(k, []).append(val)
        if save_images and out_dir:
            save_image(img, os.path.join(out_dir, f"eval_{v:03d}.png"))
    return {k: float(np.mean(v)) for k, v in per.items()}


def save_image(img: np.ndarray, path: str) -> None:
    """An [H, W, 3] image in [0, 1] as an 8-bit PNG (PIL, imported here)."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def spherical_poses(n_frames: int, radius: float = 4.0,
                    phi_deg: float = -30.0) -> np.ndarray:
    """[F, 4, 4] c2w poses on a ring around the origin (OpenCV
    convention), the reference's pose_spherical ring @ blender2opencv
    (nerf_synth360_ft_dataset.py:43,178)."""
    poses = []
    phi = np.deg2rad(phi_deg)
    for theta in np.linspace(-np.pi, np.pi, n_frames, endpoint=False):
        campos = radius * np.array([
            np.cos(theta) * np.cos(phi) * -1.0,
            np.sin(theta) * np.cos(phi) * -1.0,
            -np.sin(phi)])
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)                   # OpenCV: y down
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, fwd, campos
        poses.append(m)
    return np.stack(poses)


def interpolated_poses(c2ws: np.ndarray, n_views: int = 30) -> np.ndarray:
    """A smooth path through the dataset cameras (the reference's
    `gen_render_path`, mvs_utils.py:261-290): n_views // 3 frames between
    each pair of consecutive cameras (the last back to the first),
    xyz-euler angles and positions interpolated linearly, each frame's
    angles shifted within 180 degrees of the previous frame's."""
    from scipy.spatial.transform import Rotation

    c2ws = np.asarray(c2ws, np.float64)
    n = len(c2ws)
    steps = max(n_views // 3, 1)
    eulers, positions = [], []
    for i in range(n):
        e = Rotation.from_matrix(c2ws[i, :3, :3]).as_euler("xyz",
                                                            degrees=True)
        if i:
            e += 360.0 * np.round((eulers[-1] - e) / 360.0)
        eulers.append(e)
        positions.append(c2ws[i, :3, 3])
    w = np.linspace(1.0, 0.0, steps, endpoint=False)[:, None]
    out = []
    for i in range(n):
        j = (i + 1) % n
        for ang, pos in zip(w * eulers[i] + (1 - w) * eulers[j],
                            w * positions[i] + (1 - w) * positions[j]):
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = Rotation.from_euler("xyz", ang,
                                            degrees=True).as_matrix()
            m[:3, 3] = pos
            out.append(m)
    return np.stack(out)


def render_video(cfg: PointNerfConfig, params, points, grid,
                 intrinsics: np.ndarray, hw, near: float, far: float,
                 out_path: str, n_frames: int = 60, radius: float = 4.0,
                 chunk: int = 4096, fps: int = 30, fast: bool = False,
                 frame: bool = True,
                 poses: Optional[np.ndarray] = None) -> str:
    """Render a camera path (`poses` [F, 4, 4] c2w, default a spherical
    ring of `n_frames`) and write it with imageio (imported here): a GIF
    when `out_path` ends in .gif, else through imageio's video writer,
    which raises where no video backend is installed. Returns the path."""
    _unported(cfg)
    frame_render = render_chunk = None
    if fast and frame:
        raster = None
        if cfg.query.march_steps:
            k = np.asarray(intrinsics)
            raster = (hw[0], hw[1], (float(k[0, 0]), float(k[1, 1]),
                                     float(k[0, 2]), float(k[1, 2])))
        frame_render = make_fast_frame_renderer(cfg, points, grid, near, far,
                                                chunk=chunk, raster=raster)
    else:
        render_chunk = (make_fast_chunk_fn(cfg, points, grid, near, far)
                        if fast else make_render_chunk_fn(cfg))
    h, w = hw
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    xy = np.stack([i, j], -1).reshape(-1, 2)
    frames = []
    for pose in (poses if poses is not None
                 else spherical_poses(n_frames, radius=radius)):
        rays = pixel_raydirs(xy, intrinsics, pose[:3, :3])
        if frame_render is not None:
            img = frame_render(params, pose[:3, 3], pose[:3, :3],
                               rays).coarse_raycolor.cpu().numpy()
        else:
            img = render_image(render_chunk, params, points, grid,
                               pose[:3, 3], pose[:3, :3], rays, hw, near,
                               far, chunk)["coarse_raycolor"]
        frames.append((np.clip(img.reshape(h, w, 3), 0, 1) * 255
                       ).astype(np.uint8))
    import imageio
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if out_path.endswith(".gif"):
        imageio.mimwrite(out_path, frames, duration=1000.0 / fps, loop=0)
    else:
        imageio.mimwrite(out_path, frames, fps=fps, quality=8)
    return out_path
