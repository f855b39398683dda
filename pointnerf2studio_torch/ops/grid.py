"""Voxel-grid construction over a neural point cloud.

Port of `pointnerf2studio_tpu/ops/grid.py` (compute_grid_geometry,
build_grid, _dilate_occupancy, CandidateCache, build_candidate_cache,
build_grid_from_points). The build is a
stable sort by voxel id plus scatters whose live indices are unique, so
it is deterministic on every device: when a voxel holds more than P
points the first P by point index are kept, and the first `max_o`
occupied voxels in flat-id order. The only scatter with repeated
indices is an integer count, whose result does not depend on order.
The candidate cache takes its candidates, in their order, from
`models/fast_render.ordered_candidates`, as the fat and geometry caches
do: sorts and gathers, no scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pointnerf2studio_torch.config import QueryConfig


@dataclasses.dataclass
class CandidateCache:
    """Per-query-voxel candidate lists of the legacy render's K-NN
    (`ops/query.knn_from_cache`): for each query voxel (a dilated-occupied
    voxel) the first C candidates of its kernel_size neighbourhood by
    (Chebyshev shell, distance to the voxel centre), each packed as [x, y,
    z, bitcast_f32(pidx), shell] with pidx -1 and shell 127 on an empty
    slot, flattened to cand_pack [max_q, C * 5] float32 as the reference
    lays it out."""
    coor_2_qslot: torch.Tensor      # [gx, gy, gz] int32 query slot or -1
    cand_pack: torch.Tensor         # [max_q, C * 5] float32
    n_q: torch.Tensor               # [] int32 query voxels

    def unpack(self, rows: torch.Tensor):
        """rows [M, C * 5] -> (xyz [M, C, 3], pidx int32 [M, C],
        shell int32 [M, C])."""
        rows = rows.reshape(*rows.shape[:-1], -1, 5)
        return (rows[..., :3], rows[..., 3].contiguous().view(torch.int32),
                rows[..., 4].to(torch.int32))


@dataclasses.dataclass
class PointGrid:
    """Dense voxel grid over the neural point cloud (device tensors)."""
    ranges_min: torch.Tensor        # [3] world coords of grid origin
    scaled_vsize: torch.Tensor      # [3] voxel edge lengths
    coor_2_occ: torch.Tensor        # [gx, gy, gz] int32 occupied slot or -1
    coor_occ: torch.Tensor          # [gx, gy, gz] bool dilated occupancy
    occ_2_pnts: torch.Tensor        # [max_o, P] int32 point ids, -1 padded
    occ_numpnts: torch.Tensor       # [max_o] int32 points per voxel
    n_occ: torch.Tensor             # [] int32 occupied voxels
    occ_2_coor: torch.Tensor        # [max_o, 3] int32 voxel coord per slot
    cache: Optional[CandidateCache] = None

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.coor_occ.shape)


def compute_grid_geometry(xyz_min: np.ndarray, xyz_max: np.ndarray,
                          cfg: QueryConfig):
    """Host-side grid origin + static dims from a point bounding box
    (clip to cfg.ranges, pad by kernel_size/2 voxels, round dims up to
    grid_dim_pad)."""
    ranges = np.asarray(cfg.ranges, np.float32)
    svsize = np.asarray(cfg.scaled_vsize, np.float32)
    ks = np.asarray(cfg.kernel_size, np.float32)
    lo = (np.maximum(np.asarray(xyz_min, np.float32), ranges[:3])
          - svsize * ks / 2)
    hi = (np.minimum(np.asarray(xyz_max, np.float32), ranges[3:])
          + svsize * ks / 2)
    vdim = (hi - lo) / np.asarray(cfg.vsize, np.float32)
    dims = np.ceil(vdim / np.asarray(cfg.vscale, np.float32)).astype(np.int64)
    pad = cfg.grid_dim_pad
    dims = np.maximum((dims + pad - 1) // pad * pad, pad)
    return lo, (int(dims[0]), int(dims[1]), int(dims[2]))


def _dilate_occupancy(occ: torch.Tensor,
                      query_size: Tuple[int, int, int]) -> torch.Tensor:
    """Max over the window [c - (q+1)/2 + 1, c + q/2] around each voxel
    (the reference's query-window scatter, read as a gather)."""
    window = tuple(int(q) for q in query_size)
    pads = []
    for q in reversed(window):          # F.pad takes the last dim first
        pads += [(q + 1) // 2 - 1, q // 2]
    x = F.pad(occ.float()[None, None], pads)
    return F.max_pool3d(x, window, stride=1)[0, 0] > 0


def build_grid(xyz: torch.Tensor, alive: torch.Tensor,
               ranges_min: torch.Tensor, scaled_vsize: torch.Tensor,
               dims: Tuple[int, int, int], max_o: int, P: int,
               query_size: Tuple[int, int, int]) -> PointGrid:
    """Build the dense voxel grid. Deterministic."""
    dev = xyz.device
    n = xyz.shape[0]
    gx, gy, gz = dims
    nvox = gx * gy * gz
    i32 = torch.int32

    gcoor = torch.floor((xyz - ranges_min) / scaled_vsize).long()
    dims_t = torch.tensor(dims, device=dev)
    inb = alive & ((gcoor >= 0) & (gcoor < dims_t)).all(-1)
    flat = gcoor[:, 0] * (gy * gz) + gcoor[:, 1] * gz + gcoor[:, 2]
    flat = torch.where(inb, flat, torch.full_like(flat, nvox))

    sflat, spid = torch.sort(flat, stable=True)
    valid = sflat < nvox
    prev = torch.cat([sflat.new_full((1,), -1), sflat[:-1]])
    head = valid & (sflat != prev)
    slot = torch.cumsum(head.long(), 0) - 1
    pos = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(head, pos, 0), 0).values
    rank = pos - seg_start
    n_occ = head.sum().to(i32)

    keep = valid & (slot < max_o)
    store = keep & (rank < P)
    occ_2_pnts = torch.full((max_o + 1, P), -1, dtype=i32, device=dev)
    occ_2_pnts[torch.where(store, slot, max_o),
               torch.where(store, rank, 0)] = spid.to(i32)
    occ_numpnts = torch.zeros(max_o + 1, dtype=i32, device=dev).index_add_(
        0, torch.where(keep, slot, max_o), torch.ones_like(slot, dtype=i32))

    head_put = head & (slot < max_o)
    c2o = torch.full((nvox + 1,), -1, dtype=i32, device=dev)
    c2o[torch.where(head_put, sflat, nvox)] = slot.to(i32)
    coor_2_occ = c2o[:nvox].reshape(dims)
    coor_occ = _dilate_occupancy(coor_2_occ >= 0, query_size)

    occ_flat = torch.full((max_o + 1,), nvox, dtype=torch.long, device=dev)
    occ_flat[torch.where(head_put, slot, max_o)] = sflat
    occ_flat = occ_flat[:max_o]
    occ_2_coor = torch.where(
        (occ_flat < nvox)[:, None],
        torch.stack([occ_flat // (gy * gz), (occ_flat // gz) % gy,
                     occ_flat % gz], -1), -1).to(i32)

    return PointGrid(
        ranges_min=ranges_min.float(), scaled_vsize=scaled_vsize.float(),
        coor_2_occ=coor_2_occ, coor_occ=coor_occ,
        occ_2_pnts=occ_2_pnts[:max_o], occ_numpnts=occ_numpnts[:max_o],
        n_occ=n_occ, occ_2_coor=occ_2_coor)


@torch.no_grad()
def build_candidate_cache(grid: PointGrid, xyz: torch.Tensor,
                          kernel_size: Tuple[int, int, int], max_q: int,
                          cand_cap: int, chunk: int = 32768
                          ) -> CandidateCache:
    """The legacy render's candidate cache of `grid` (see CandidateCache),
    C = min(cand_cap, V * P) candidates a query voxel, built once per grid
    in pieces of `chunk` query voxels."""
    from pointnerf2studio_torch.models.fast_render import (
        cand_width, candidate_pieces, query_voxels)
    C = cand_width(grid, kernel_size, cand_cap)
    coor_2_qslot, n_q, q_coor, q_live, center_w = query_voxels(grid, max_q)
    pack = torch.empty((max_q, C, 5), dtype=torch.float32,
                       device=xyz.device)
    for sl, (sel_ok, sel_pidx, sel_sh, sel_xyz) in candidate_pieces(
            grid, xyz, kernel_size, C, q_coor, center_w, q_live, chunk):
        pack[sl, :, :3] = sel_xyz
        pack[sl, :, 3] = torch.where(sel_ok, sel_pidx, -1).to(
            torch.int32).view(torch.float32)
        pack[sl, :, 4] = torch.where(sel_ok, sel_sh, 127).float()
    return CandidateCache(coor_2_qslot=coor_2_qslot,
                          cand_pack=pack.reshape(max_q, C * 5), n_q=n_q)


def dense_dims_feasible(dims) -> bool:
    """Whether [gx, gy, gz] dense int32 tables are representable and
    affordable: flat voxel ids fit int32 and one table stays within 4 GiB
    (a grid holds two, and the caches a qslot table). Past this, the
    sparse grid of ops/hash_grid.py serves the extent."""
    nvox = int(dims[0]) * int(dims[1]) * int(dims[2])
    return nvox <= 2 ** 31 - 1 and nvox * 4 <= 4 * 2 ** 30


def live_bbox(xyz: torch.Tensor, alive: torch.Tensor):
    """(min [3], max [3]) numpy of the live points' coordinates."""
    big = torch.tensor(1e30, device=xyz.device)
    a3 = alive[:, None]
    return (torch.where(a3, xyz, big).min(0).values.cpu().numpy(),
            torch.where(a3, xyz, -big).max(0).values.cpu().numpy())


def build_grid_from_points(xyz: torch.Tensor, alive: torch.Tensor,
                           cfg: QueryConfig) -> PointGrid:
    """Host-side geometry from the live-point bbox, then the build; with
    `cfg.use_cache` the grid carries its candidate cache (max_q defaults
    to 4 * max_o, as in the reference). Raises ValueError where the dense
    tables are not feasible (`dense_dims_feasible`)."""
    ranges_min, dims = compute_grid_geometry(*live_bbox(xyz, alive), cfg)
    if not dense_dims_feasible(dims):
        raise ValueError(
            f"dense grid dims {dims} exceed the dense table budget; use the "
            f"sparse grid for this extent (grid_mode='hash' / 'auto', or "
            f"ops/hash_grid.build_hash_grid_from_points + "
            f"make_hash_fast_scene / make_hash_geo_scene)")
    grid = build_grid(
        xyz, alive, torch.as_tensor(ranges_min, device=xyz.device),
        torch.tensor(cfg.scaled_vsize, dtype=torch.float32,
                     device=xyz.device),
        dims, cfg.max_o, cfg.P, cfg.query_size)
    if cfg.use_cache:
        grid.cache = build_candidate_cache(
            grid, xyz, cfg.kernel_size, cfg.max_q or 4 * cfg.max_o,
            cfg.cand_cap)
    return grid
