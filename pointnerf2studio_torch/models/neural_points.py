"""Neural point cloud: the point store.

Port of `pointnerf2studio_tpu/models/neural_points.py` (NeuralPointCloud
with its trainable set, from_arrays, gather_neighbors, whole or
row-sharded over a mesh axis, and the structure changes prune, grow and
expand_capacity, each of which returns a new cloud and leaves its
argument as it is). Static-capacity
layout: arrays are allocated at `capacity` rows with an `alive` mask;
names match the reference checkpoint keys (xyz, points_embeding,
points_conf, points_dir, points_color, Rw2c: [3, 3] global or [N, 3, 3]
per point).

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
import torch.nn.functional as F

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


SCAN_ROW = 4096     # elements a row of the two-level prefix sum


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a 1-D tensor whose association is fixed:
    rows of SCAN_ROW elements scanned along their last dim, then the row
    totals, each row offset by the sum of the rows before it. torch's
    cumsum of a 1-D CUDA tensor (one device-wide scan whose tiles take
    their predecessors' sums as the threads happen to publish them) groups
    a float sum differently from run to run; a scan along the last dim of
    a [rows, SCAN_ROW] tensor does not."""
    n = x.shape[0]
    B = max(-(-n // SCAN_ROW), 1)
    rows = torch.cumsum(F.pad(x, (0, B * SCAN_ROW - n)).view(B, SCAN_ROW), 1)
    tot = rows[:, -1]
    # the row totals as two rows, so that this scan too runs along a last
    # dim and not as one device-wide scan
    off = torch.cumsum(torch.stack([tot, torch.zeros_like(tot)]), 1)[0] - tot
    return (rows + off[:, None]).view(-1)[:n]


def _segment_sum_rows(g: torch.Tensor, idx: torch.Tensor, n_rows: int
                      ) -> torch.Tensor:
    """sum over i with idx[i] == r of g[i], for every r < n_rows: the rows
    of g [n, C] sorted stably by idx, float64 prefix sums, each run's sum
    as the difference of its ends, written once to its row. No step
    depends on the order in which threads run. The prefix sums run as one
    scan of the flat [C, n] array (a scan down dim 0 of [n, C] runs only C
    parallel chains: 6 ms a chunk on the card; `_prefix_sums`), each
    column's sums then taken relative to its start."""
    n, C = g.shape
    sidx, perm = torch.sort(idx, stable=True)
    flat = _prefix_sums(g[perm].double().t().reshape(-1)).view(C, n)
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


def gather_attrs(attrs: torch.Tensor, pidx: torch.Tensor,
                 points_axis=None) -> torch.Tensor:
    """attrs[pidx] for ids pidx [...] (-1 = empty, gathered clamped) as
    [..., C], through `gather_rows`. With `points_axis`
    (parallel/sharding.Axis) the table holds this rank's rows [j *
    n_local, (j + 1) * n_local) of a table row-sharded over that axis:
    each rank gathers the rows it owns, zeroes the others, and one psum
    completes the gather (its backward the identity, so the gradient
    reaches each rank's rows through `gather_rows`' backward alone). The
    empty ids gather zeros there, where the whole table gives row 0."""
    n_local = attrs.shape[0]
    if points_axis is None:
        idx = torch.clamp(pidx, 0, n_local - 1)
        return gather_rows(attrs, idx.reshape(-1)).reshape(
            pidx.shape + (attrs.shape[1],))
    from pointnerf2studio_torch.parallel.sharding import axis_index, psum
    loc = pidx.long() - axis_index(points_axis) * n_local
    own = (loc >= 0) & (loc < n_local)
    vals = gather_rows(attrs, torch.clamp(loc, 0, n_local - 1).reshape(-1)
                       ).reshape(pidx.shape + (attrs.shape[1],))
    return psum(vals * own[..., None].to(vals.dtype), points_axis)


def gather_neighbors(points: NeuralPointCloud, sample_pidx: torch.Tensor,
                     points_axis=None) -> Dict[str, torch.Tensor]:
    """Per-neighbour attributes for point ids sample_pidx [..., K]
    (-1 = empty) as padded [..., K, .] tensors: xyz, embeding, conf,
    dir, color, and Rw2c [..., K, 3, 3] for a per-point Rw2c. Empty slots
    gather a clamped index and must be masked downstream via
    `sample_pidx >= 0`. The trainable attributes go through one
    `gather_attrs`, so their gradient takes `gather_rows`' backward. With
    `points_axis` the trainable attributes are this rank's rows of a
    cloud row-sharded over that axis (parallel/sharding.shard_cloud),
    while xyz, Rw2c and the ids stay whole (reference :97-145)."""
    idx = torch.clamp(sample_pidx, 0, points.capacity - 1).long()
    attrs = torch.cat([points.points_embeding, points.points_conf,
                       points.points_dir, points.points_color], -1)
    vals = gather_attrs(attrs, sample_pidx, points_axis)
    C = points.points_embeding.shape[1]
    out = {"xyz": points.xyz[idx], "embeding": vals[..., :C],
           "conf": vals[..., C:C + 1], "dir": vals[..., C + 1:C + 4],
           "color": vals[..., C + 4:C + 7]}
    if points.Rw2c.ndim == 3:
        out["Rw2c"] = points.Rw2c[idx]
    return out


@torch.no_grad()
def prune(points: NeuralPointCloud, conf_thresh: float) -> NeuralPointCloud:
    """Kill the live points whose confidence is below `conf_thresh`: only
    the mask changes (reference `NeuralPoints.prune`,
    models/neural_points/neural_points.py:341-364)."""
    keep = points.alive & (points.points_conf[:, 0] >= conf_thresh)
    return dataclasses.replace(points, alive=keep)


@torch.no_grad()
def grow(points: NeuralPointCloud, new_xyz: torch.Tensor,
         new_embeding: torch.Tensor, new_conf: torch.Tensor,
         new_dir: torch.Tensor, new_color: torch.Tensor,
         new_valid: torch.Tensor) -> NeuralPointCloud:
    """Write up to M candidates into the dead slots: candidate i goes to
    the i-th dead slot in ascending order; candidates past the free count,
    and those whose `new_valid` is False, are dropped (the capacity is
    fixed; `expand_capacity` makes room). New tensors, no atomics: the
    targets are distinct, the dropped ones write to a sentinel row."""
    cap = points.capacity
    dead = ~points.alive
    order = torch.argsort((~dead).to(torch.int8), stable=True)  # dead first
    target = order[:min(new_xyz.shape[0], cap)]
    T = target.shape[0]
    n_free = dead.sum()
    can_place = new_valid[:T] & (torch.arange(T, device=target.device)
                                 < n_free)
    dest = torch.where(can_place, target, cap)

    def put(dst, src):
        out = torch.cat([dst.detach(), dst[:1].detach()])
        out[dest] = src[:T].to(dst.dtype)
        return out[:cap]

    return dataclasses.replace(
        points, xyz=put(points.xyz, new_xyz),
        points_embeding=put(points.points_embeding, new_embeding),
        points_conf=put(points.points_conf, new_conf),
        points_dir=put(points.points_dir, new_dir),
        points_color=put(points.points_color, new_color),
        alive=put(points.alive, torch.ones_like(new_valid)))


@torch.no_grad()
def expand_capacity(points: NeuralPointCloud, new_capacity: int
                    ) -> NeuralPointCloud:
    """Every per-point tensor padded to `new_capacity` rows of dead,
    zero slots (a per-point Rw2c too); raises on a shrink."""
    cap = points.capacity
    if new_capacity < cap:
        raise ValueError(f"cannot shrink capacity {cap} -> {new_capacity}")
    if new_capacity == cap:
        return points

    def padrow(a):
        a = a.detach()
        return torch.cat([a, a.new_zeros((new_capacity - cap,)
                                         + a.shape[1:])])

    return dataclasses.replace(
        points, xyz=padrow(points.xyz),
        points_embeding=padrow(points.points_embeding),
        points_conf=padrow(points.points_conf),
        points_dir=padrow(points.points_dir),
        points_color=padrow(points.points_color),
        Rw2c=padrow(points.Rw2c) if points.Rw2c.ndim == 3 else points.Rw2c,
        alive=padrow(points.alive))
