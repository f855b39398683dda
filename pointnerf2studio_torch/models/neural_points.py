"""Neural point cloud: the point store.

Port of `pointnerf2studio_tpu/models/neural_points.py` (NeuralPointCloud
and from_arrays). Static-capacity layout: arrays are allocated at
`capacity` rows with an `alive` mask; names match the reference
checkpoint keys (xyz, points_embeding, points_conf, points_dir,
points_color, Rw2c).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class NeuralPointCloud:
    xyz: torch.Tensor               # [N, 3] float32
    points_embeding: torch.Tensor   # [N, C]
    points_conf: torch.Tensor       # [N, 1]
    points_dir: torch.Tensor        # [N, 3]
    points_color: torch.Tensor      # [N, 3]
    Rw2c: torch.Tensor              # [3, 3] global (per-point not ported)
    alive: torch.Tensor             # [N] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def from_arrays(
    xyz: np.ndarray,
    points_embeding: np.ndarray,
    points_conf: np.ndarray,
    points_dir: np.ndarray,
    points_color: np.ndarray,
    Rw2c: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    device: torch.device | str = "cpu",
) -> NeuralPointCloud:
    """Build a point cloud on `device`, padded to `capacity` dead rows."""
    n = xyz.shape[0]
    cap = capacity or n

    def pad(a):
        a = torch.as_tensor(np.asarray(a, np.float32).reshape(n, -1))
        if cap != n:
            a = torch.cat([a, a.new_zeros((cap - n, a.shape[1]))])
        return a.to(device)

    if Rw2c is None:
        Rw2c = np.eye(3, dtype=np.float32)
    return NeuralPointCloud(
        xyz=pad(xyz), points_embeding=pad(points_embeding),
        points_conf=pad(points_conf), points_dir=pad(points_dir),
        points_color=pad(points_color),
        Rw2c=torch.as_tensor(np.asarray(Rw2c, np.float32)).to(device),
        alive=(torch.arange(cap) < n).to(device))
