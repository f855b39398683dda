"""Ray-sample masking, shading-slot compaction and the K-nearest-neighbour
query.

Port of `pointnerf2studio_tpu/ops/query.py`: the grid route of the
legacy render (`mask_raypos`, `_knn_chunk`, `knn_for_locs`; a grid
without a candidate cache), its cache route (`mask_raypos_qslot`,
`knn_from_cache`; a grid built with `QueryConfig.use_cache`), the
build-time candidate pruning of the fast caches (`candidate_keep_mask`),
and the whole fixed-shape query (`compact_shading_locs`,
`query_grid_point_index`).

Selection semantics are the reference's: candidates are scanned shell
by shell in Chebyshev layers; a shell is searched only while the shells
inside it yielded fewer than K candidates; within the searched shells
the K nearest within `radius_limit` win, earlier scan order breaking
ties. `lax.top_k` breaks ties by smallest index and `torch.topk`
promises no order, so every selection here is a stable sort of the keys.
Distances are plain float32 sums of squares (the reference's compiled
CPU program may contract them into fused multiply-adds; parity inputs
stay off exact ties).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.ops.grid import PointGrid


def neighbor_offsets(kernel_size: Tuple[int, int, int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Scan-ordered voxel offsets and their Chebyshev shell ids: shell 0
    first, then each shell's offsets in x-major order (the reference's
    layer/x/y/z loop nest, query_worldcoords.cu:256-263)."""
    num_layers = (kernel_size[0] + 1) // 2
    offs, shells = [], []
    for layer in range(num_layers):
        for x in range(-layer, layer + 1):
            for y in range(-layer, layer + 1):
                for z in range(-layer, layer + 1):
                    if max(abs(x), abs(y), abs(z)) != layer:
                        continue
                    offs.append((x, y, z))
                    shells.append(layer)
    return np.asarray(offs, np.int32), np.asarray(shells, np.int32)


@dataclasses.dataclass
class QueryResult:
    """Fixed-shape output of the neighbour query (padded + masked)."""
    sample_pidx: torch.Tensor     # [R, SR, K] int32 point ids, -1 = empty
    sample_loc_w: torch.Tensor    # [R, SR, 3] shading locations (0 pad)
    sample_mask: torch.Tensor     # [R, SR] bool: slot holds a sample
    ray_mask: torch.Tensor        # [R] bool: a sample found neighbours


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def candidate_keep_mask(rel, shell, valid, half, radius2: float, K: int,
                        max_shell: int) -> torch.Tensor:
    """Exact build-time candidate pruning of the fast caches: drop a
    candidate that no shading location inside the voxel could select, by
    the radius (its least distance to the voxel cube, rel [B, C, 3] being
    the offset from the voxel centre, past the radius) or, in the
    outermost shell only, by K feasible candidates all nearer at their
    farthest than it is at its nearest. Survivors keep their order."""
    a = torch.abs(rel)
    lo = _norm3(torch.clamp(a - half, min=0.0))                # [B, C]
    hi = _norm3(a + half)
    feasible = valid
    if radius2 > 0:
        feasible = feasible & (lo * lo <= radius2)
    dom_cnt = ((hi[:, None, :] < lo[:, :, None])
               & feasible[:, None, :]).sum(-1)
    return feasible & ~((shell >= max_shell) & (dom_cnt >= K))


def voxel_coords(xyz: torch.Tensor, ranges_min: torch.Tensor,
                 scaled_vsize: torch.Tensor) -> torch.Tensor:
    """World position -> integer voxel coordinate (floor), int64."""
    return torch.floor((xyz - ranges_min) / scaled_vsize).long()


def grid_coords(grid: PointGrid, xyz: torch.Tensor) -> torch.Tensor:
    """The voxel of each position in the grid's tables: its voxel from
    the grid's origin, less the tables' first voxel where the grid is a
    slab of a larger one (`PointGrid.origin`)."""
    gcoor = voxel_coords(xyz, grid.ranges_min, grid.scaled_vsize)
    if grid.origin is not None:
        gcoor = gcoor - torch.tensor(grid.origin, device=xyz.device)
    return gcoor


def mask_raypos(grid: PointGrid, raypos: torch.Tensor) -> torch.Tensor:
    """[R, D] bool: sample position lies in a dilated-occupied voxel."""
    dims = torch.tensor(grid.dims, device=raypos.device)
    gcoor = grid_coords(grid, raypos)
    inb = ((gcoor >= 0) & (gcoor < dims)).all(-1)
    gc = torch.minimum(torch.clamp(gcoor, min=0), dims - 1)
    return inb & grid.coor_occ[gc[..., 0], gc[..., 1], gc[..., 2]]


def mask_raypos_qslot(grid: PointGrid, raypos: torch.Tensor) -> torch.Tensor:
    """[R, D] int32 query slot of each sample in the grid's candidate
    cache, -1 where it is not a query voxel (outside the grid, not
    dilated-occupied, or past max_q)."""
    dims = torch.tensor(grid.dims, device=raypos.device)
    gcoor = voxel_coords(raypos, grid.ranges_min, grid.scaled_vsize)
    inb = ((gcoor >= 0) & (gcoor < dims)).all(-1)
    gc = torch.minimum(torch.clamp(gcoor, min=0), dims - 1)
    q = grid.cache.coor_2_qslot[gc[..., 0], gc[..., 1], gc[..., 2]]
    return torch.where(inb, q, -1)


def compact_shading_locs(raypos: torch.Tensor, raypos_mask: torch.Tensor,
                         SR: int, extra: Optional[torch.Tensor] = None):
    """The first SR masked samples of each ray in SR fixed slots:
    (sample_loc_w [R, SR, 3], 0 on empty slots; sample_mask [R, SR][,
    extra_slots [R, SR], `extra`'s value there, -1 on empty slots])."""
    R, D, _ = raypos.shape
    col = torch.arange(D, device=raypos.device)
    key = torch.where(raypos_mask, col, D)
    d_sel = torch.sort(key, dim=-1, stable=True).values[:, :SR]
    if d_sel.shape[1] < SR:
        d_sel = torch.cat([d_sel, d_sel.new_full((R, SR - D), D)], -1)
    sample_mask = d_sel < D
    d_c = torch.clamp(d_sel, max=D - 1)
    sample_loc_w = torch.gather(raypos, 1, d_c[..., None].expand(R, SR, 3)
                                ) * sample_mask[..., None].to(raypos.dtype)
    if extra is None:
        return sample_loc_w, sample_mask
    return sample_loc_w, sample_mask, torch.where(
        sample_mask, torch.gather(extra, 1, d_c), -1)


def _knn_chunk(grid: PointGrid, xyz: torch.Tensor, locs: torch.Tensor,
               loc_mask: torch.Tensor, offsets: torch.Tensor,
               shells: torch.Tensor, num_shells: int, K: int,
               radius2: float, layered: bool) -> torch.Tensor:
    """K nearest live points for one chunk of shading locations
    -> [C, K] int32 point ids, -1 = empty."""
    C = locs.shape[0]
    P = grid.occ_2_pnts.shape[1]
    V = offsets.shape[0]
    dev = locs.device
    dims = torch.tensor(grid.dims, device=dev)

    center = grid_coords(grid, locs)
    nb = center[:, None, :] + offsets[None, :, :]                  # [C, V, 3]
    nb_inb = ((nb >= 0) & (nb < dims)).all(-1)
    nbc = torch.minimum(torch.clamp(nb, min=0), dims - 1)
    occ_slot = grid.coor_2_occ[nbc[..., 0], nbc[..., 1], nbc[..., 2]]
    slot_valid = nb_inb & (occ_slot >= 0) & loc_mask[:, None]

    cand = grid.occ_2_pnts[torch.where(slot_valid, occ_slot, 0).long()]
    cand_valid = slot_valid[..., None] & (cand >= 0)               # [C, V, P]
    cand_xyz = xyz[torch.clamp(cand, 0, xyz.shape[0] - 1).long()]
    delta = cand_xyz - locs[:, None, None, :]
    d2 = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]
          + delta[..., 2] * delta[..., 2])
    if radius2 > 0.0:
        cand_valid = cand_valid & (d2 <= radius2)

    cand_valid = cand_valid.reshape(C, V * P)
    d2 = d2.reshape(C, V * P)
    cand = cand.reshape(C, V * P)

    if layered:
        # a shell is searched only if the shells inside it yielded < K
        # candidates
        shell_per_cand = shells.repeat_interleave(P)                # [V*P]
        before = torch.zeros((C, 1), dtype=torch.long, device=dev)
        eligible = torch.zeros_like(cand_valid)
        for s in range(num_shells):
            in_s = shell_per_cand == s
            eligible = eligible | (in_s & (before < K))
            before = before + (cand_valid & in_s).sum(-1, keepdim=True)
        cand_valid = cand_valid & eligible

    key = torch.where(cand_valid, d2, float("inf"))
    top_key, top_idx = torch.sort(key, dim=-1, stable=True)
    top_key, top_idx = top_key[:, :K], top_idx[:, :K]
    top_pidx = torch.gather(cand, 1, top_idx)
    return torch.where(top_key < float("inf"), top_pidx, -1).to(torch.int32)


@torch.no_grad()
def knn_for_locs(grid: PointGrid, xyz: torch.Tensor, locs: torch.Tensor,
                 loc_mask: torch.Tensor, K: int, radius2: float,
                 kernel_size: Tuple[int, int, int], layered: bool = True,
                 chunk: int = 8192) -> torch.Tensor:
    """K nearest point ids for a flat list of locations -> [M, K] int32.
    Runs in `chunk`-sized pieces to bound the [chunk, V*P] candidate
    working set; the pieces change no result."""
    offs_np, shells_np = neighbor_offsets(kernel_size)
    dev = locs.device
    offsets = torch.as_tensor(offs_np, dtype=torch.long, device=dev)
    shells = torch.as_tensor(shells_np, dtype=torch.long, device=dev)
    num_shells = int(shells_np.max()) + 1
    total = locs.shape[0]
    if total == 0:
        return torch.zeros((0, K), dtype=torch.int32, device=dev)
    return torch.cat([
        _knn_chunk(grid, xyz, locs[s:s + chunk], loc_mask[s:s + chunk],
                   offsets, shells, num_shells, K, radius2, layered)
        for s in range(0, total, chunk)])


def layered_k_nearest(d2: torch.Tensor, ok: torch.Tensor,
                      shell: torch.Tensor, K: int, num_shells: int,
                      layered: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K smallest d2 [M, C] among the candidates `ok` [M, C] of a
    cache row, with their Chebyshev `shell` [M, C]: (top [M, K] column
    ids, found [M, K] bool). With `layered` a shell is searched only while
    the shells inside it kept fewer than K. Ties go to the smaller column
    (a stable sort; `torch.topk` promises no order)."""
    if layered and num_shells > 1:
        eligible = shell == 0
        before = torch.zeros_like(shell[:, :1])
        for s in range(1, num_shells):
            before = before + (ok & (shell == s - 1)).sum(-1, keepdim=True)
            eligible = eligible | ((shell == s) & (before < K))
        ok = ok & eligible
    key = torch.where(ok, d2, float("inf"))
    top_key, top = torch.sort(key, dim=-1, stable=True)
    return top[:, :K], top_key[:, :K] < float("inf")


@torch.no_grad()
def knn_from_cache(grid: PointGrid, qslot: torch.Tensor, locs: torch.Tensor,
                   loc_mask: torch.Tensor, K: int, radius2: float,
                   num_shells: int, layered: bool = True) -> torch.Tensor:
    """The K nearest candidates of each location from its query voxel's
    row of the candidate cache (qslot [M], locs [M, 3], loc_mask [M])
    -> [M, K] int32 point ids, -1 = empty. Candidates out of the radius
    are dropped; with `layered` a shell is searched only while the shells
    inside it kept fewer than K; the K smallest d2 win, ties to the
    earlier column (a stable sort)."""
    cache = grid.cache
    rows = cache.cand_pack[torch.clamp(qslot, min=0).long()]   # [M, C*5]
    cxyz, pidx, shell = cache.unpack(rows)
    ok = ((qslot >= 0) & loc_mask)[:, None] & (pidx >= 0)
    delta = cxyz - locs[:, None, :]
    d2 = (delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]
          + delta[..., 2] * delta[..., 2])
    if radius2 > 0.0:
        ok = ok & (d2 <= radius2)
    top, found = layered_k_nearest(d2, ok, shell, K, num_shells, layered)
    return torch.where(found, torch.gather(pidx, 1, top), -1).to(torch.int32)


@torch.no_grad()
def query_grid_point_index(grid: PointGrid, xyz: torch.Tensor,
                           raypos: torch.Tensor, SR: int, K: int,
                           radius2: float, kernel_size: Tuple[int, int, int],
                           layered: bool = True,
                           chunk: int = 8192) -> QueryResult:
    """The whole query on the grid: mask -> the first SR samples of each
    ray -> K-NN, at fixed shapes. A ray is in `ray_mask` when it hit
    occupied space and one of its samples found a neighbour."""
    R = raypos.shape[0]
    rp_mask = mask_raypos(grid, raypos)
    loc, smask = compact_shading_locs(raypos, rp_mask, SR)
    pidx = knn_for_locs(grid, xyz, loc.reshape(R * SR, 3),
                        smask.reshape(R * SR), K, radius2, kernel_size,
                        layered=layered, chunk=chunk).reshape(R, SR, K)
    return QueryResult(sample_pidx=pidx, sample_loc_w=loc, sample_mask=smask,
                       ray_mask=rp_mask.any(-1) & (pidx >= 0).any(-1).any(-1))
