"""Neural point cloud: the point store.

Port of `pointnerf2studio_tpu/models/neural_points.py` (NeuralPointCloud
with its trainable set, from_arrays and the single-device
gather_neighbors). Static-capacity layout: arrays are allocated at
`capacity` rows with an `alive` mask; names match the reference
checkpoint keys (xyz, points_embeding, points_conf, points_dir,
points_color, Rw2c: [3, 3] global or [N, 3, 3] per point).

The attributes are gathered by `gather_rows`, whose backward does not
depend on launch order: it sorts the row ids stably and sums each row's
run of gradients from float64 prefix sums, then writes each row once; no
atomic accumulation sits on the gradient's path. (torch's own backward
of an indexing, a sorted `index_put_` accumulate, is deterministic too,
but it runs each row's duplicates in series: 64 of a chair train step's
78 ms of device time on an NVIDIA H100.)
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
    Rw2c: torch.Tensor              # [3, 3] global or [N, 3, 3] per point
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


def _segment_sum_rows(g: torch.Tensor, idx: torch.Tensor, n_rows: int
                      ) -> torch.Tensor:
    """sum over i with idx[i] == r of g[i], for every r < n_rows: the rows
    of g [n, C] sorted stably by idx, float64 prefix sums, each run's sum
    as the difference of its ends, written once to its row. No step
    depends on the order in which threads run. The prefix sums run as one
    scan of the flat [C, n] array (a scan down dim 0 of [n, C] runs only C
    parallel chains: 6 ms a chunk on the card), each column's sums then
    taken relative to its start."""
    n, C = g.shape
    sidx, perm = torch.sort(idx, stable=True)
    flat = torch.cumsum(g[perm].double().t().reshape(-1), 0).view(C, n)
    before_col = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    cs = (flat - before_col[:, None]).t()                        # [n, C]
    pos = torch.arange(n, device=g.device)
    last = torch.ones(n, dtype=torch.bool, device=g.device)
    last[:-1] = sidx[1:] != sidx[:-1]
    first = torch.ones_like(last)
    first[1:] = last[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    before = torch.where((start > 0)[:, None], cs[start - 1],
                         torch.zeros_like(cs[:1]))
    out = g.new_zeros((n_rows + 1, C))
    out[torch.where(last, sidx, n_rows)] = (cs - before).to(g.dtype)
    return out[:n_rows]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _segment_sum_rows(g.contiguous(), idx, ctx.n_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for table [N, C] and idx [n] int64, with a backward
    (`_segment_sum_rows`) that does not depend on launch order."""
    return _GatherRows.apply(table, idx.long())


def gather_neighbors(points: NeuralPointCloud, sample_pidx: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """Per-neighbour attributes for point ids sample_pidx [..., K]
    (-1 = empty) as padded [..., K, .] tensors: xyz, embeding, conf,
    dir, color, and Rw2c [..., K, 3, 3] for a per-point Rw2c. Empty slots
    gather a clamped index and must be masked downstream via
    `sample_pidx >= 0`. The trainable attributes go through one
    `gather_rows`, so their gradient takes its backward. Single device
    only: the reference's row-sharded gather is not ported."""
    idx = torch.clamp(sample_pidx, 0, points.capacity - 1).long()
    attrs = torch.cat([points.points_embeding, points.points_conf,
                       points.points_dir, points.points_color], -1)
    vals = gather_rows(attrs, idx.reshape(-1)).reshape(
        idx.shape + (attrs.shape[1],))
    C = points.points_embeding.shape[1]
    out = {"xyz": points.xyz[idx], "embeding": vals[..., :C],
           "conf": vals[..., C:C + 1], "dir": vals[..., C + 1:C + 4],
           "color": vals[..., C + 4:C + 7]}
    if points.Rw2c.ndim == 3:
        out["Rw2c"] = points.Rw2c[idx]
    return out
