"""Spatially sharded voxel grid: an exact K-NN query over x-slab grids with
halos, for clouds whose dense grid and candidate lists exceed one device.

Port of `pointnerf2studio_tpu/parallel/grid_shard.py`. The grid is cut
into x-axis slabs over a mesh axis ("points"; `sharding.make_mesh(n,
axis_name="points")`):

  * every rank builds a grid over its slab plus a halo of
    (kernel_size - 1) / 2 + 1 voxels (at least (query_size + 1) / 2), so
    that a query at the slab's border is exact with no exchange during
    the query;
  * a ray sample belongs to the one slab that holds its voxel's x; each
    rank masks and K-NNs only the samples it owns;
  * the sample masks merge with one psum (as int32) and the neighbour ids
    with one pmax (-1 = empty).

xyz and alive stay whole on every rank; only the grid scales down. The
result equals the unsharded query for any slab decomposition, up to the
order of equidistant neighbours (tests/test_torch_grid_shard.py).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import QueryConfig
from pointnerf2studio_torch.ops.grid import (
    PointGrid, build_grid, compute_grid_geometry)
from pointnerf2studio_torch.ops.query import (
    compact_shading_locs, knn_for_locs, mask_raypos, voxel_coords)
from pointnerf2studio_torch.parallel.sharding import Mesh, pmax, psum


def slab_geometry(cfg: QueryConfig, xyz_min: np.ndarray, xyz_max: np.ndarray,
                  n_slabs: int
                  ) -> Tuple[np.ndarray, Tuple[int, int, int], int, int]:
    """The slab decomposition of the global grid along x: (global
    ranges_min, global dims, slab width in voxels without the halo, halo
    width in voxels). Every slab's local grid has dims (slab_w + 2 * halo,
    gy, gz)."""
    ranges_min, dims = compute_grid_geometry(xyz_min, xyz_max, cfg)
    slab_w = -(-dims[0] // n_slabs)
    halo = max((cfg.kernel_size[0] - 1) // 2 + 1,
               (cfg.query_size[0] + 1) // 2)
    return np.asarray(ranges_min, np.float32), dims, slab_w, halo


def build_slab_grid(xyz: torch.Tensor, alive: torch.Tensor,
                    cfg: QueryConfig, ranges_min: torch.Tensor,
                    dims: Tuple[int, int, int], slab_w: int, halo: int,
                    slab_idx: int, max_o_local: int
                    ) -> Tuple[PointGrid, int]:
    """One rank's grid over voxels [slab_idx * slab_w - halo, + slab_w +
    halo) along x (the points outside it dead for this build), and the
    local grid's first voxel x. The slab keeps the global origin and
    shifts voxel indices by x0 (`PointGrid.origin`): a point or sample on
    a voxel face falls into the voxel it falls into globally. (The
    reference shifts the float origin by x0 voxels instead, whose rounding
    can move it to the next voxel.)"""
    svs = torch.as_tensor(cfg.scaled_vsize, dtype=torch.float32,
                          device=xyz.device)
    x0 = slab_idx * slab_w - halo
    local_dims = (slab_w + 2 * halo, dims[1], dims[2])
    gc_x = voxel_coords(xyz, ranges_min, svs)[:, 0]
    in_local = alive & (gc_x >= x0) & (gc_x < x0 + local_dims[0])
    grid = build_grid(xyz, in_local, ranges_min, svs, local_dims,
                      max_o_local, cfg.P, cfg.query_size, origin=(x0, 0, 0))
    return grid, x0


def make_sharded_query(cfg: QueryConfig, mesh: Mesh, ranges_min: np.ndarray,
                       dims: Tuple[int, int, int], slab_w: int, halo: int,
                       max_o_local: int, axis: str = "points") -> Callable:
    """The exact K-NN query over a slab-sharded grid:

        query(xyz, alive, raypos [R, D, 3]) -> (sample_pidx [R, SR, K],
            sample_loc_w [R, SR, 3], sample_mask [R, SR], ray_mask [R])

    all whole on every rank. Collectives: one [R, D] psum (the sample
    masks) and one [R, SR, K] pmax (the neighbour ids)."""
    SR, K = cfg.SR, cfg.K
    radius2 = cfg.radius_limit ** 2
    ax = mesh.axis(axis)
    if ax is None:
        raise ValueError(f"mesh has no {axis!r} axis")
    idx = ax.index

    @torch.no_grad()
    def query(xyz, alive, raypos):
        dev = xyz.device
        rmin = torch.as_tensor(ranges_min, dtype=torch.float32, device=dev)
        svs = torch.as_tensor(cfg.scaled_vsize, dtype=torch.float32,
                              device=dev)
        grid, _ = build_slab_grid(xyz, alive, cfg, rmin, dims, slab_w, halo,
                                  idx, max_o_local)
        # ownership: the sample's global voxel x lies in this slab
        gc = voxel_coords(raypos, rmin, svs)
        own = ((gc[..., 0] >= idx * slab_w)
               & (gc[..., 0] < min((idx + 1) * slab_w, dims[0]))
               & (gc[..., 0] >= 0))
        rp_mask = psum((mask_raypos(grid, raypos) & own).to(torch.int32),
                       ax) > 0
        ray_hit = rp_mask.any(-1)
        sample_loc_w, sample_mask = compact_shading_locs(raypos, rp_mask, SR)

        # this rank K-NNs only the shading locations it owns
        loc_gc_x = voxel_coords(sample_loc_w, rmin, svs)[..., 0]
        loc_own = (sample_mask & (loc_gc_x >= idx * slab_w)
                   & (loc_gc_x < (idx + 1) * slab_w))
        R = raypos.shape[0]
        pidx = knn_for_locs(
            grid, xyz, sample_loc_w.reshape(R * SR, 3),
            loc_own.reshape(R * SR), K, radius2, cfg.kernel_size,
            layered=cfg.layered_search).reshape(R, SR, K)
        pidx = pmax(pidx, ax)                                  # -1 = empty
        ray_found = (pidx >= 0).any(-1).any(-1)
        return pidx, sample_loc_w, sample_mask, ray_hit & ray_found

    return query
