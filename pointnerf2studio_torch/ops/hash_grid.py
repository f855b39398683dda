"""Sparse (bucketed-hash) voxel grid for large-extent scenes.

Port of `pointnerf2studio_tpu/ops/hash_grid.py`. The dense grid
(ops/grid.py) holds [gx, gy, gz] tables; at the ScanNet and
Tanks&Temples presets (vsize 0.008-0.002 over metres) the logical dims
reach thousands per axis, past any table the card can hold. Here the
query voxels live in one open-addressed bucket table [B, S * W] int32
(W = 5 words a slot: x, y, z, occupied slot, qslot; -1 where empty), and
the logical dims are host ints that bound coordinates and never size an
allocation.

The build equals the reference's word for word: the occupied voxels in
(x, y, z) order (a stable sort of an int64 key, the row-major index over
the logical dims, whose order is the lexicographic one), the first P
points of each by point index, the first max_o voxels; the dilated
(query) voxels from each occupied voxel's query-window offsets, deduped
by a sort whose key puts the voxel's own emission first; qslot = rank in
(x, y, z) order, the dense build's numbering; the table filled by a
stable sort of the bucket ids of the query voxels in that order, so a
bucket's slots hold its voxels in (x, y, z) order. No scatter adds:
every indexed store writes distinct places, and the per-voxel point
counts are segment lengths of the sorted order. A bucket that receives
more than S voxels drops the rest and counts them in `overflow`;
`build_hash_grid_from_points` doubles B until it reads zero.

Lookups walk the S slots of a bucket one word-gather at a time (no
[samples, S * W] row is formed): peak extra memory is a few int64 and
bool tensors of the lookup's shape.

The bucket hash (`_mix_coords`) is the reference's uint32 arithmetic in
int64, masked to 32 bits after every product and shift, with each
product split in 16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import QueryConfig
from pointnerf2studio_torch.ops.grid import (
    build_grid_from_points, compute_grid_geometry, dense_dims_feasible,
    live_bbox)

W = 5          # int32 words per table slot: x, y, z, occ_slot, qslot
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class HashGrid:
    """Sparse voxel grid (device tensors; logical dims on the host)."""
    ranges_min: torch.Tensor        # [3] f32 world coords of grid origin
    scaled_vsize: torch.Tensor      # [3] f32 voxel edge lengths
    dims: Tuple[int, int, int]      # logical bounds (never a shape)
    table: torch.Tensor             # [B, S * W] int32; empty slots -1
    occ_2_pnts: torch.Tensor        # [max_o, P] int32 point ids, -1 padded
    occ_numpnts: torch.Tensor       # [max_o] int32
    occ_2_coor: torch.Tensor        # [max_o, 3] int32, -1 padded
    n_occ: torch.Tensor             # [] int32 occupied voxels
    n_q: torch.Tensor               # [] int32 dilated (query) voxels
    overflow: torch.Tensor          # [] int32 voxels dropped by bucket
                                    # capacity S (non-zero: rebuild bigger)

    @property
    def n_buckets(self) -> int:
        return self.table.shape[0]

    @property
    def bucket_slots(self) -> int:
        return self.table.shape[1] // W


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2^32 for int64 u in [0, 2^32) and a 32-bit constant c,
    with no int64 product past 2^48."""
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix_coords(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                n_buckets: int) -> torch.Tensor:
    """Integer voxel coordinates -> bucket id int64 in [0, n_buckets) (a
    power of two): per-axis odd multipliers and a murmur3-style finalizer,
    in uint32 arithmetic as the reference computes it (a negative
    coordinate takes its two's-complement uint32 value)."""
    x, y, z = (a.long() & _M32 for a in (x, y, z))
    u = (_mul32(x, 0x9E3779B1) ^ _mul32(y, 0x85EBCA77)
         ^ _mul32(z, 0xC2B2AE3D))
    u = u ^ (u >> 16)
    u = _mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return u & (n_buckets - 1)


def _dilation_offsets(query_size: Tuple[int, int, int]) -> np.ndarray:
    """Offsets o such that occupied voxel c dilates c + o: o in
    [-(q // 2), (q + 1) // 2 - 1] per axis (ops/grid._dilate_occupancy's
    window), in (x, y, z) row-major order."""
    axes = [np.arange(-(q // 2), (q + 1) // 2) for q in query_size]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return grid.astype(np.int32)


def _flat(c: torch.Tensor, dims: Tuple[int, int, int]) -> torch.Tensor:
    """Row-major index over the logical dims, int64 ([..., 3] in bounds)."""
    c = c.long()
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def _unflat(f: torch.Tensor, dims: Tuple[int, int, int]) -> torch.Tensor:
    gz = dims[2]
    gyz = dims[1] * gz
    return torch.stack([f // gyz, (f // gz) % dims[1], f % gz], -1)


def _run_starts(key: torch.Tensor) -> torch.Tensor:
    """[n] bool: where a run of equal values of sorted `key` begins."""
    first = torch.ones_like(key[:1], dtype=torch.bool)
    return torch.cat([first, key[1:] != key[:-1]])


@torch.no_grad()
def build_hash_grid(xyz: torch.Tensor, alive: torch.Tensor,
                    ranges_min: torch.Tensor, scaled_vsize: torch.Tensor,
                    dims: Tuple[int, int, int], n_buckets: int,
                    bucket_slots: int, max_o: int, P: int,
                    query_size: Tuple[int, int, int]) -> HashGrid:
    """Deterministic sparse grid build (the module docstring), the
    semantics of ops/grid.build_grid without any [gx, gy, gz] array."""
    dev = xyz.device
    i32, i64 = torch.int32, torch.long
    B, S = n_buckets, bucket_slots
    dims = tuple(int(d) for d in dims)
    nflat = dims[0] * dims[1] * dims[2]
    if nflat >= 2 ** 62:
        raise ValueError(f"logical dims {dims} exceed the int64 voxel key")
    sentinel = torch.iinfo(i64).max

    # ---- occupied voxels: stable sort of the (x, y, z) key, point order
    # kept within a voxel
    gcoor = torch.floor((xyz - ranges_min) / scaled_vsize).long()
    dims_t = torch.tensor(dims, device=dev)
    inb = alive & ((gcoor >= 0) & (gcoor < dims_t)).all(-1)
    key = torch.where(inb, _flat(torch.clamp(gcoor, min=0), dims), sentinel)
    skey, spid = torch.sort(key, stable=True)
    n_valid = int(inb.sum())
    skey, spid = skey[:n_valid], spid[:n_valid]
    head = _run_starts(skey)
    starts = torch.nonzero(head).squeeze(1)                    # [n_occ]
    n_occ_i = starts.shape[0]
    slot = torch.cumsum(head.long(), 0) - 1
    rank = torch.arange(n_valid, device=dev) - starts[slot]
    store = (slot < max_o) & (rank < P)
    occ_2_pnts = torch.full((max_o, P), -1, dtype=i32, device=dev)
    occ_2_pnts[slot[store], rank[store]] = spid[store].to(i32)
    n_keep = min(n_occ_i, max_o)
    ends = torch.cat([starts[1:], starts.new_full((1,), n_valid)])
    occ_numpnts = torch.zeros(max_o, dtype=i32, device=dev)
    occ_numpnts[:n_keep] = (ends - starts)[:n_keep].to(i32)
    occ_coor = _unflat(skey[starts[:n_keep]], dims)            # [n_keep, 3]
    occ_2_coor = torch.full((max_o, 3), -1, dtype=i32, device=dev)
    occ_2_coor[:n_keep] = occ_coor.to(i32)

    # ---- query voxels: each kept occupied voxel emits its dilation
    # offsets; key = 2 * flat + (not its own voxel), so the voxel's own
    # emission (which carries its occupied slot) heads its group. Rows
    # past n_keep emit nothing, as their sentinels sort last in the
    # reference.
    offs = torch.as_tensor(_dilation_offsets(query_size), device=dev).long()
    V = offs.shape[0]
    zero_off = (offs == 0).all(-1)                              # [V]
    em = occ_coor[:, None, :] + offs[None]                 # [n_keep, V, 3]
    em_in = ((em >= 0) & (em < dims_t)).all(-1)
    ekey = torch.where(
        em_in, 2 * _flat(torch.clamp(em, min=0), dims)
        + (~zero_off).long()[None], sentinel).reshape(-1)
    del em, em_in
    ekey, eidx = torch.sort(ekey)
    n_em = int((ekey != sentinel).sum())
    ekey, eidx = ekey[:n_em], eidx[:n_em]
    ehead = _run_starts(ekey >> 1)
    hkey = ekey[ehead]
    n_q_i = hkey.shape[0]
    q_coor = _unflat(hkey >> 1, dims)                           # [n_q, 3]
    q_occ = torch.where((hkey & 1) == 0, eidx[ehead] // V, -1)  # occ slot
    del ekey, eidx, ehead, hkey

    # ---- hash insert: a stable sort of the bucket ids keeps (x, y, z)
    # order within a bucket; the first S of each bucket are stored
    bu = _mix_coords(q_coor[:, 0], q_coor[:, 1], q_coor[:, 2], B)
    sbu, order = torch.sort(bu, stable=True)
    bstart = _run_starts(sbu)
    pos = torch.arange(n_q_i, device=dev)
    run0 = torch.cummax(torch.where(bstart, pos, 0), 0).values
    brank = pos - run0
    put = brank < S
    overflow = int((~put).sum())
    table = torch.full((B * S, W), -1, dtype=i32, device=dev)
    words = torch.cat([q_coor, q_occ[:, None], pos[:, None]], -1)[order]
    table[(sbu * S + brank)[put]] = words[put].to(i32)

    def scalar(v):
        return torch.tensor(v, dtype=i32, device=dev)

    return HashGrid(
        ranges_min=ranges_min.float(), scaled_vsize=scaled_vsize.float(),
        dims=dims, table=table.reshape(B, S * W), occ_2_pnts=occ_2_pnts,
        occ_numpnts=occ_numpnts, occ_2_coor=occ_2_coor,
        n_occ=scalar(n_occ_i), n_q=scalar(n_q_i), overflow=scalar(overflow))


def table_qslot(table: torch.Tensor, coords: torch.Tensor,
                inb: torch.Tensor, want_occ: bool = False):
    """qslot of each voxel coords [..., 3] (-1: not a query voxel) from a
    bucket table, with the caller's in-bounds mask; with `want_occ`,
    (found, occ_slot, qslot). The S slots of each bucket are read one
    word-gather at a time; at most one slot matches, so the match's value
    is the reference's max over the row."""
    B = table.shape[0]
    S = table.shape[1] // W
    x, y, z = (coords[..., i].long() for i in range(3))
    flat = table.reshape(-1)
    base = torch.where(inb, _mix_coords(x, y, z, B), 0) * (S * W)
    qslot = torch.full(x.shape, -1, dtype=torch.int32, device=table.device)
    occ = qslot.clone() if want_occ else None
    found = torch.zeros_like(inb) if want_occ else None
    for s in range(S):
        b = base + s * W
        m = (inb & (flat[b] == x) & (flat[b + 1] == y)
             & (flat[b + 2] == z))
        qslot = torch.where(m, flat[b + 4], qslot)
        if want_occ:
            occ = torch.where(m, flat[b + 3], occ)
            found = found | m
    return (found, occ, qslot) if want_occ else qslot


def hash_lookup(hg: HashGrid, coords: torch.Tensor):
    """Voxel coords [..., 3] -> (found [...], occ_slot [...], qslot [...]):
    found mirrors the dense grid's dilated `coor_occ`, occ_slot its
    `coor_2_occ` (-1 where unoccupied), qslot the caches' `coor_2_qslot`
    (-1 where not a query voxel)."""
    dims_t = torch.tensor(hg.dims, device=coords.device)
    inb = ((coords >= 0) & (coords < dims_t)).all(-1)
    return table_qslot(hg.table, coords, inb, want_occ=True)


def mask_raypos_hash(hg: HashGrid, raypos: torch.Tensor) -> torch.Tensor:
    """[..., 3] world sample positions -> bool dilated-occupancy mask (the
    sparse twin of ops/query.mask_raypos)."""
    coords = torch.floor((raypos - hg.ranges_min) / hg.scaled_vsize).long()
    return hash_lookup(hg, coords)[0]


def suggest_buckets(n_entries: int, bucket_slots: int = 16) -> int:
    """Power-of-two bucket count for a mean load of at most S / 4."""
    target = max(1, (4 * n_entries) // max(bucket_slots, 1))
    return max(1024, int(2 ** int(np.ceil(np.log2(target)))))


def build_hash_grid_from_points(xyz: torch.Tensor, alive: torch.Tensor,
                                cfg: QueryConfig, bucket_slots: int = 16,
                                max_attempts: int = 4) -> HashGrid:
    """Geometry from the live-point bbox (as the dense
    build_grid_from_points), then the build, doubling the bucket count
    until overflow == 0; raises after `max_attempts` builds."""
    xyz_min, xyz_max = live_bbox(xyz, alive)
    ranges_min, dims = compute_grid_geometry(xyz_min, xyz_max, cfg)
    # an estimate of the dilated entries: coherent surfaces dilate some
    # 3-6x; an underestimate shows as overflow, which the loop corrects
    n_entries = min(cfg.max_o, int(xyz.shape[0])) * 6
    B = suggest_buckets(n_entries, bucket_slots)
    hg = None
    for _ in range(max_attempts):
        hg = build_hash_grid(
            xyz, alive, torch.as_tensor(ranges_min, device=xyz.device),
            torch.tensor(cfg.scaled_vsize, dtype=torch.float32,
                         device=xyz.device),
            dims, B, bucket_slots, cfg.max_o, cfg.P, cfg.query_size)
        if int(hg.overflow) == 0:
            return hg
        B *= 2
    raise RuntimeError(
        f"hash grid bucket overflow persisted at B={B // 2} "
        f"(n_occ={int(hg.n_occ)}); pathological coordinate distribution?")


def build_query_grid(xyz: torch.Tensor, alive: torch.Tensor,
                     cfg: QueryConfig):
    """The grid of QueryConfig.grid_mode: "dense" (a PointGrid), "hash"
    (a HashGrid) or "auto", dense while its tables are feasible
    (ops/grid.dense_dims_feasible) and the hash grid past that. Callers
    branch on isinstance(grid, HashGrid)."""
    mode = cfg.grid_mode
    if mode == "dense":
        return build_grid_from_points(xyz, alive, cfg)
    if mode == "hash":
        return build_hash_grid_from_points(xyz, alive, cfg)
    if mode != "auto":
        raise ValueError(f"unknown grid_mode {mode!r}")
    _, dims = compute_grid_geometry(*live_bbox(xyz, alive), cfg)
    if dense_dims_feasible(dims):
        return build_grid_from_points(xyz, alive, cfg)
    return build_hash_grid_from_points(xyz, alive, cfg)
