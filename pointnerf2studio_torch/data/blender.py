"""Blender (NeRF-Synthetic) dataset and the host pixel sampler.

A copy of the jax-free `pointnerf2studio_tpu/data/blender.py`
(reference: pointnerf/data/nerf_synth360_ft_dataset.py:379-452 and
pointnerf/data/data_utils.py:55-69): c2w in the OpenCV convention
(+z forward), focal = 0.5 * W / tan(0.5 * camera_angle_x), near/far
(2, 6), ray directions (x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1,
rotated by the c2w rotation and normalised. Plain numpy on the host.

`load_blender` (PNG frames through PIL) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

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


def load_blender(root: str, split: str = "train", factor: int = 1,
                 bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 max_views: Optional[int] = None) -> BlenderDataset:
    """Reading a scene directory is not ported."""
    raise NotImplementedError(
        "load_blender (transforms_<split>.json + PNG frames through PIL) "
        "waits for ROADMAP queue 1 item 10; build a BlenderDataset from "
        "arrays")


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
