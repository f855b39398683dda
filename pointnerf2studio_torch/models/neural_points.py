"""Neural point cloud: the point store.

Port of `pointnerf2studio_tpu/models/neural_points.py` (NeuralPointCloud
with its trainable set, from_arrays and the single-device
gather_neighbors). Static-capacity layout: arrays are allocated at
`capacity` rows with an `alive` mask; names match the reference
checkpoint keys (xyz, points_embeding, points_conf, points_dir,
points_color, Rw2c).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pointnerf2studio_torch.ops._cuda import resolve_device


TRAINABLE = ("points_embeding", "points_conf", "points_dir", "points_color")


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

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum().to(torch.int32)

    def trainable(self) -> Dict[str, torch.Tensor]:
        """The point attributes the `neural_points` optimizer group
        trains; xyz, Rw2c and alive stay frozen."""
        return {name: getattr(self, name) for name in TRAINABLE}

    def with_trainable(self, t: Dict[str, torch.Tensor]
                       ) -> "NeuralPointCloud":
        return dataclasses.replace(self, **t)


def from_arrays(
    xyz: np.ndarray,
    points_embeding: np.ndarray,
    points_conf: np.ndarray,
    points_dir: np.ndarray,
    points_color: np.ndarray,
    Rw2c: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    device: torch.device | str | None = None,
) -> NeuralPointCloud:
    """Build a point cloud on `device` (None: the card; raises without
    one), padded to `capacity` dead rows."""
    device = resolve_device(device)
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


def gather_neighbors(points: NeuralPointCloud, sample_pidx: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Per-neighbour attributes for point ids sample_pidx [..., K]
    (-1 = empty) as padded [..., K, .] tensors: xyz, embeding, conf,
    dir, color. Empty slots gather a clamped index and must be masked
    downstream via `sample_pidx >= 0`. Single device only: the
    reference's row-sharded gather is not ported."""
    idx = torch.clamp(sample_pidx, 0, points.capacity - 1).long()
    return {"xyz": points.xyz[idx],
            "embeding": points.points_embeding[idx],
            "conf": points.points_conf[idx],
            "dir": points.points_dir[idx],
            "color": points.points_color[idx]}
