"""Scene editing: merge neural point clouds with per-part rigid
transforms.

Port of `pointnerf2studio_tpu/edit.py` (reference:
pointnerf/run/editing.py:148-236): each part checkpoint's points get a
rigid transform applied to xyz while the inverse rotation is composed
into a per-point Rw2c (so view directions and distance offsets rotate
consistently in the aggregator, point_aggregators.py:508-522); the parts
are then concatenated into one editable scene. An edited scene trains on
the legacy step (`fit()`'s default): the fast step refuses a per-point
Rw2c, as the reference's does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.neural_points import (
    NeuralPointCloud, from_arrays)
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.utils import checkpoint_io as cio


def apply_rigid_transform(
    xyz: np.ndarray, Rw2c: np.ndarray, transform: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply a 4x4 rigid transform to points; compose the rotation into
    the per-point Rw2c (editing.py:190-203 semantics)."""
    R, t = transform[:3, :3], transform[:3, 3]
    new_xyz = xyz @ R.T + t
    if Rw2c.ndim == 2:
        Rw2c = np.tile(Rw2c[None], (xyz.shape[0], 1, 1))
    # Invariant: row-vector application w_new @ Rw2c_new == w_old @
    # Rw2c_old for w_new = w_old @ R.T  =>  Rw2c_new = R @ Rw2c_old.
    new_Rw2c = R[None] @ Rw2c
    return new_xyz.astype(np.float32), new_Rw2c.astype(np.float32)


def load_and_merge_parts(
    part_paths: Sequence[str],
    transform_paths: Optional[Sequence[str]] = None,
    capacity: Optional[int] = None,
    cfg: Optional[AggregatorConfig] = None,
    device: torch.device | str | None = None,
) -> Tuple[Aggregator, NeuralPointCloud]:
    """Load N part checkpoints (`*_net_ray_marching.pth`), transform each
    by its 4x4 `.npy` (None or a missing entry: as it is), merge ->
    (Aggregator of `cfg`, default AggregatorConfig(), cloud) on `device`
    (None: the card).

    The aggregator weights come from the first part (all parts trained
    from the same base model share them, as in the reference)."""
    device = resolve_device(device)
    cfg = cfg or AggregatorConfig()
    xyz_l, emb_l, conf_l, dir_l, col_l, rw2c_l = [], [], [], [], [], []
    params = None
    for i, path in enumerate(part_paths):
        p, cloud = cio.load_reference_checkpoint(path, cfg, device="cpu")
        if cloud is None:
            raise ValueError(f"{path} holds no neural points")
        if params is None:
            params = p
        xyz = cloud.xyz.numpy()
        rw2c = cloud.Rw2c.numpy()
        if transform_paths and i < len(transform_paths) and transform_paths[i]:
            T = np.load(transform_paths[i])
            xyz, rw2c = apply_rigid_transform(xyz, rw2c, T)
        elif rw2c.ndim == 2:
            rw2c = np.tile(rw2c[None], (xyz.shape[0], 1, 1))
        xyz_l.append(xyz)
        rw2c_l.append(rw2c)
        emb_l.append(cloud.points_embeding.numpy())
        conf_l.append(cloud.points_conf.numpy())
        dir_l.append(cloud.points_dir.numpy())
        col_l.append(cloud.points_color.numpy())

    merged = from_arrays(
        np.concatenate(xyz_l), np.concatenate(emb_l),
        np.concatenate(conf_l), np.concatenate(dir_l),
        np.concatenate(col_l), Rw2c=np.concatenate(rw2c_l),
        capacity=capacity, device=device)
    return params.to(device), merged
