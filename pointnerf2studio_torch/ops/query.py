"""Ray-sample masking and the K-nearest-neighbour query on the voxel grid.

Port of `neighbor_offsets`, `mask_raypos`, `_knn_chunk` and
`knn_for_locs` from `pointnerf2studio_tpu/ops/query.py`: the route the
legacy render takes without a candidate cache (`use_cache=False`). The
cache route (`mask_raypos_qslot`, `knn_from_cache`) is not ported.

Selection semantics are the reference's: candidates are scanned shell
by shell in Chebyshev layers; a shell is searched only while the shells
inside it yielded fewer than K candidates; within the searched shells
the K nearest within `radius_limit` win, earlier scan order breaking
ties. `lax.top_k` breaks ties by smallest index and `torch.topk`
promises no order, so the selection here is a stable sort of the keys.
"""

from __future__ import annotations

from typing import Tuple

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


def voxel_coords(xyz: torch.Tensor, ranges_min: torch.Tensor,
                 scaled_vsize: torch.Tensor) -> torch.Tensor:
    """World position -> integer voxel coordinate (floor), int64."""
    return torch.floor((xyz - ranges_min) / scaled_vsize).long()


def mask_raypos(grid: PointGrid, raypos: torch.Tensor) -> torch.Tensor:
    """[R, D] bool: sample position lies in a dilated-occupied voxel."""
    dims = torch.tensor(grid.dims, device=raypos.device)
    gcoor = voxel_coords(raypos, grid.ranges_min, grid.scaled_vsize)
    inb = ((gcoor >= 0) & (gcoor < dims)).all(-1)
    gc = torch.minimum(torch.clamp(gcoor, min=0), dims - 1)
    return inb & grid.coor_occ[gc[..., 0], gc[..., 1], gc[..., 2]]


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

    center = voxel_coords(locs, grid.ranges_min, grid.scaled_vsize)
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
