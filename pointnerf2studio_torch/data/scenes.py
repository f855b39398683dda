"""ScanNet / Tanks&Temples (NSVF layout) / DTU dataset loaders.

A copy of the jax-free `pointnerf2studio_tpu/data/scenes.py` on the
port's BlenderDataset (plain numpy on the host; PIL imported where an
image is read). The "blender" kind goes to the port's `load_blender`,
which is not ported yet and raises.

The reference's dev_scripts configure ScanNet, Tanks&Temples and DTU
runs (reference: pointnerf/dev_scripts/w_scannet_etf/*.sh,
w_tt_ft/*.sh, data/dtu_configs/) but the dataset classes themselves
are absent from the repo (SURVEY.md §2.2 gap — they live upstream).
These loaders reconstruct the standard on-disk layouts:

  * ScanNet export: `exported/color/<i>.jpg`, `exported/pose/<i>.txt`
    (4x4 c2w), `exported/intrinsic/intrinsic_color.txt` (4x4), optional
    `exported/depth/<i>.png` (uint16 mm).
  * Tanks&Temples, NSVF release: `rgb/<s>_<i>.png`, `pose/<s>_<i>.txt`
    (4x4 c2w), `intrinsics.txt`, where the filename prefix <s> selects
    the split (0=train, 1=val, 2=test).
  * DTU (MVSNet layout): `Cameras/train/<i:08d>_cam.txt` (extrinsic
    4x4 w2c + intrinsic 3x3 + depth range), images
    `Rectified/scan<N>_train/rect_<i+1:03d>_<light>_r5000.png`.

All return the same `BlenderDataset` container the rest of the
framework consumes (images/poses/intrinsics/near/far), poses in the
OpenCV c2w convention.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np

from pointnerf2studio_torch.data.blender import BlenderDataset


def _load_image(path: str, factor: int = 1) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if factor > 1:
        img = img.resize((img.width // factor, img.height // factor),
                         Image.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    return arr[..., :3]


def _scale_intrinsics(K: np.ndarray, factor: int) -> np.ndarray:
    K = K.astype(np.float32).copy()
    if factor > 1:
        K[:2] /= factor
    return K


def load_scannet(
    root: str,
    split: str = "train",
    factor: int = 1,
    step: int = 1,
    max_views: Optional[int] = None,
    near: float = 0.1,
    far: float = 8.0,
    test_every: int = 10,
) -> BlenderDataset:
    """ScanNet `exported/` scene directory.

    Views are frame-ordered; every `test_every`-th frame is the test
    split (the upstream convention for the _etf fine-tune scenes).
    """
    exp = os.path.join(root, "exported")
    if not os.path.isdir(exp):
        exp = root
    color_dir = os.path.join(exp, "color")
    paths = sorted(glob(os.path.join(color_dir, "*")),
                   key=lambda p: int(re.findall(r"\d+", os.path.basename(p))[-1]))
    ids = [int(re.findall(r"\d+", os.path.basename(p))[-1]) for p in paths]
    K4 = np.loadtxt(os.path.join(exp, "intrinsic", "intrinsic_color.txt"))
    K = _scale_intrinsics(np.asarray(K4, np.float32)[:3, :3], factor)

    sel = []
    for rank, (i, p) in enumerate(zip(ids, paths)):
        is_test = rank % test_every == 0
        if (split == "test") == is_test:
            sel.append((i, p))
    sel = sel[::step][:max_views]

    images, poses = [], []
    for i, p in sel:
        pose = np.loadtxt(os.path.join(exp, "pose", f"{i}.txt")
                          ).astype(np.float32)
        if not np.all(np.isfinite(pose)):
            continue
        images.append(_load_image(p, factor))
        poses.append(pose)
    return BlenderDataset(
        images=np.stack(images), poses=np.stack(poses), intrinsics=K,
        near=near, far=far, split=split)


def load_nsvf(
    root: str,
    split: str = "train",
    factor: int = 1,
    max_views: Optional[int] = None,
    near: float = 0.0,
    far: float = 3.5,
) -> BlenderDataset:
    """NSVF-layout scene (Tanks&Temples release): rgb/ + pose/ +
    intrinsics.txt, split by filename prefix 0_/1_/2_."""
    prefix = {"train": "0", "val": "1", "test": "2"}[split]
    rgb_paths = sorted(glob(os.path.join(root, "rgb", f"{prefix}_*")))
    if max_views:
        rgb_paths = rgb_paths[:max_views]

    intr = np.loadtxt(os.path.join(root, "intrinsics.txt"))
    if intr.ndim == 2:                       # 4x4 or 3x3 matrix file
        K = np.asarray(intr, np.float32)[:3, :3]
    else:                                    # "f cx cy ..." single line
        K = np.array([[intr[0], 0, intr[1]],
                      [0, intr[0], intr[2]], [0, 0, 1]], np.float32)
    K = _scale_intrinsics(K, factor)

    images, poses = [], []
    for p in rgb_paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        pose = np.loadtxt(os.path.join(root, "pose", stem + ".txt")
                          ).astype(np.float32).reshape(4, 4)
        images.append(_load_image(p, factor))
        poses.append(pose)
    return BlenderDataset(
        images=np.stack(images), poses=np.stack(poses), intrinsics=K,
        near=near, far=far, split=split)


def _parse_mvsnet_cam(path: str) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float]]:
    """MVSNet cam file: `extrinsic` 4x4 (w2c), `intrinsic` 3x3,
    depth_min / interval line."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    ei = lines.index("extrinsic")
    w2c = np.array([[float(x) for x in lines[ei + 1 + r].split()]
                    for r in range(4)], np.float32)
    ii = lines.index("intrinsic")
    K = np.array([[float(x) for x in lines[ii + 1 + r].split()]
                  for r in range(3)], np.float32)
    tail = [425.0, 2.5]
    for ln in lines[ii + 4:]:
        if ln:
            tail = [float(x) for x in ln.split()]
            break
    depth_min = tail[0]
    depth_max = tail[0] + tail[1] * 192 if len(tail) > 1 else tail[0] + 480.0
    return w2c, K, (depth_min, depth_max)


def load_dtu(
    root: str,
    scan: str = "scan1",
    split: str = "train",
    factor: int = 1,
    light_idx: int = 3,
    max_views: Optional[int] = None,
    test_views: Sequence[int] = (32, 24, 23, 44),
) -> BlenderDataset:
    """DTU in the MVSNet directory layout."""
    cam_dir = os.path.join(root, "Cameras", "train")
    cam_paths = sorted(glob(os.path.join(cam_dir, "*_cam.txt")))
    n = len(cam_paths)
    view_ids = [i for i in range(n)
                if (i in test_views) == (split == "test")]
    if max_views:
        view_ids = view_ids[:max_views]

    images, poses = [], []
    K_out, nf = None, (425.0, 905.0)
    for i in view_ids:
        w2c, K, depth_range = _parse_mvsnet_cam(cam_paths[i])
        img_path = os.path.join(
            root, "Rectified", f"{scan}_train",
            f"rect_{i + 1:03d}_{light_idx}_r5000.png")
        if not os.path.exists(img_path):
            img_path = os.path.join(
                root, "Rectified", scan,
                f"rect_{i + 1:03d}_{light_idx}_r5000.png")
        images.append(_load_image(img_path, factor))
        poses.append(np.linalg.inv(w2c).astype(np.float32))
        K_out, nf = _scale_intrinsics(K, factor), depth_range
    return BlenderDataset(
        images=np.stack(images), poses=np.stack(poses), intrinsics=K_out,
        near=nf[0], far=nf[1], split=split)


def load_scene(kind: str, root: str, **kwargs) -> BlenderDataset:
    """Dataset factory by family name (the reference's
    `data/__init__.py:10-31` string-keyed factory)."""
    loaders = {
        "blender": None,  # handled below to avoid a cycle
        "nerf_synth360": None,
        "scannet": load_scannet,
        "tt": load_nsvf,
        "nsvf": load_nsvf,
        "dtu": load_dtu,
    }
    if kind not in loaders:
        raise KeyError(f"unknown dataset kind: {kind!r}")
    if loaders[kind] is None:
        from pointnerf2studio_torch.data.blender import load_blender
        return load_blender(root, **kwargs)
    return loaders[kind](root, **kwargs)
