"""Blender (NeRF-Synthetic) dataset: transforms_*.json + PNG frames,
and the host pixel sampler.

A copy of the jax-free `pointnerf2studio_tpu/data/blender.py`
(reference: pointnerf/data/nerf_synth360_ft_dataset.py:379-452 and
pointnerf/data/data_utils.py:55-69):
  * c2w = transform_matrix @ BLENDER2OPENCV (the y/z axis flip to the
    OpenCV camera, +z forward),
  * focal = 0.5 * W / tan(0.5 * camera_angle_x),
  * RGBA composited onto a white background,
  * near/far = (2.0, 6.0),
  * ray directions (x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1, rotated
    by the c2w rotation and normalised.
Plain numpy on the host; `load_blender` reads the frames through PIL,
imported where it is used.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
    dtype=np.float32)

NEAR_FAR = (2.0, 6.0)


@dataclasses.dataclass
class BlenderDataset:
    images: np.ndarray        # [V, H, W, 3] float32 in [0, 1], white-composited
    poses: np.ndarray         # [V, 4, 4] c2w, OpenCV convention
    intrinsics: np.ndarray    # [3, 3]
    near: float
    far: float
    split: str
    # per-view alpha (coverage) masks — the reference's binary depth /
    # `depth_gt > 0` on blender data (nerf_synth360_ft_dataset.py
    # builds them from the RGBA alpha channel); None when frames had
    # no alpha.
    alphas: Optional[np.ndarray] = None     # [V, H, W] float32

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    @property
    def hw(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def campos(self, view: int) -> np.ndarray:
        return self.poses[view, :3, 3]

    def camrotc2w(self, view: int) -> np.ndarray:
        return self.poses[view, :3, :3]

    def raydirs(self, view: int, pixel_xy: np.ndarray) -> np.ndarray:
        """Normalized world ray dirs for integer pixel coords [N, 2] (x, y)."""
        return pixel_raydirs(pixel_xy, self.intrinsics, self.camrotc2w(view))

    def full_image_rays(self, view: int) -> np.ndarray:
        h, w = self.hw
        i, j = np.meshgrid(np.arange(w), np.arange(h))
        xy = np.stack([i, j], -1).reshape(-1, 2)
        return self.raydirs(view, xy)


def pixel_raydirs(pixel_xy: np.ndarray, intrinsic: np.ndarray,
                  camrotc2w: np.ndarray, normalize: bool = True) -> np.ndarray:
    """get_dtu_raydir semantics (data_utils.py:55-69)."""
    x = (pixel_xy[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixel_xy[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    dirs = np.stack([x, y, np.ones_like(x)], -1)
    dirs = dirs @ camrotc2w.T
    if normalize:
        dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-5)
    return dirs.astype(np.float32)


def load_blender(
    root: str,
    split: str = "train",
    factor: int = 1,
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    max_views: Optional[int] = None,
) -> BlenderDataset:
    """Load a NeRF-Synthetic scene directory (transforms_<split>.json):
    the first `max_views` frames, each downscaled by `factor` (LANCZOS),
    RGBA composited onto `bg_color` with its alpha kept, RGB as it is, a
    grey frame repeated to RGB; `file_path` with or without ".png"."""
    from PIL import Image

    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)

    frames = meta["frames"][:max_views] if max_views else meta["frames"]
    images, poses, alphas = [], [], []
    for frame in frames:
        path = os.path.join(root, frame["file_path"] + ".png")
        if not os.path.exists(path):
            path = os.path.join(root, frame["file_path"])
        img = Image.open(path)
        if factor > 1:
            img = img.resize((img.width // factor, img.height // factor),
                             Image.LANCZOS)
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, -1)
        if arr.shape[-1] == 4:
            rgb, a = arr[..., :3], arr[..., 3:]
            arr = rgb * a + np.asarray(bg_color, np.float32) * (1.0 - a)
            alphas.append(a[..., 0])
        images.append(arr[..., :3])
        c2w = np.asarray(frame["transform_matrix"], np.float32) @ BLENDER2OPENCV
        poses.append(c2w)

    images = np.stack(images)
    poses = np.stack(poses)
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    intrinsics = np.array(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float32)
    return BlenderDataset(
        images=images, poses=poses, intrinsics=intrinsics,
        near=NEAR_FAR[0], far=NEAR_FAR[1], split=split,
        alphas=np.stack(alphas) if len(alphas) == len(frames) else None)


class PixelSampler:
    """Per-step ray batches: ONE random view, `rays_per_batch` pixels
    from it (Point-NeRF trains per-image — reference:
    pointnerf/nerfstudio/studio_datamanager.py:62-81).

    `mode` mirrors the reference's --random_sample
    (nerf_synth360_ft_dataset.py:589-618): "random" integer pixels,
    "random2" continuous uniform coords (ray dirs from the float
    coords, gt from their floor), "patch" one contiguous square patch,
    "no_crop" the full image grid (batch size becomes H*W).
    """

    def __init__(self, dataset: BlenderDataset, rays_per_batch: int,
                 seed: int = 0, mode: str = "random"):
        if mode not in ("random", "random2", "patch", "no_crop"):
            raise ValueError(f"unknown pixel-sample mode {mode!r}")
        self.dataset = dataset
        self.rays_per_batch = rays_per_batch
        self.rng = np.random.default_rng(seed)
        self.mode = mode

    def _pixels(self, h: int, w: int):
        n = self.rays_per_batch
        if self.mode == "random":
            xs = self.rng.integers(0, w, n).astype(np.float32)
            ys = self.rng.integers(0, h, n).astype(np.float32)
        elif self.mode == "random2":
            xs = self.rng.uniform(0, w - 1e-5, n).astype(np.float32)
            ys = self.rng.uniform(0, h - 1e-5, n).astype(np.float32)
        elif self.mode == "patch":
            s = max(1, int(np.sqrt(n)))
            x0 = int(self.rng.integers(0, w - s + 1))
            y0 = int(self.rng.integers(0, h - s + 1))
            px, py = np.meshgrid(np.arange(x0, x0 + s),
                                 np.arange(y0, y0 + s))
            xs = px.reshape(-1).astype(np.float32)
            ys = py.reshape(-1).astype(np.float32)
        else:  # no_crop
            px, py = np.meshgrid(np.arange(w), np.arange(h))
            xs = px.reshape(-1).astype(np.float32)
            ys = py.reshape(-1).astype(np.float32)
        return xs, ys

    def next_batch(self):
        ds = self.dataset
        view = int(self.rng.integers(ds.num_views))
        h, w = ds.hw
        xs, ys = self._pixels(h, w)
        xy = np.stack([xs, ys], -1)
        raydirs = ds.raydirs(view, xy)
        xi = xs.astype(np.int64)
        yi = ys.astype(np.int64)
        gt = ds.images[view, yi, xi]
        batch = {
            "view": view,
            "campos": ds.campos(view),
            "camrotc2w": ds.camrotc2w(view),
            "raydirs": raydirs,
            "gt_rgb": gt.astype(np.float32),
            "pixel_xy": np.stack([xi, yi], -1),
            "near": ds.near,
            "far": ds.far,
        }
        if ds.alphas is not None:
            batch["gt_mask"] = (ds.alphas[view, yi, xi] > 0.0)
        return batch
