"""Fast eval render path: fat candidate cache + slot compaction + chunk
decode + composite.

Port of `pointnerf2studio_tpu/models/fast_render.py`: the candidate
cache (the content of the reference's kernel-facing "fused" layout,
stored candidate-major, which every route reads: see `FatCache`),
`build_fat_cache`, `fit_cand_cap`, `make_fast_scene`, and
`fast_render_rays` through

  ray packing (QueryConfig.ray_budget) ->
  dense qslot lookup, optionally clipped to a per-ray depth window ->
  first-BP valid columns per ray (ops/select.py; the CUDA kernel under
  select_mode="pallas") -> rank-gather pack to M = R * compact_budget
  slots -> the chunk decode -> packed alpha composite (or, under
  `prob`, the [R, BP] slot-grid composite with the per-ray opacity
  argmax),

with every exactness counter the reference returns on that path
(dw_overflow, rb_overflow, cb_overflow) and n_valid_slots. The chunk
decode is one of

  knn_mode="xla", chunk_mode="xla" (the reference's default): the XLA
  candidate stages of `chunk_pipeline` as torch ops, in chunks of CH
  slots (`_xla_chunk`: the fat-row gather, candidate d2, the radius /
  valid / layered-shell masks, the exact K smallest by a stable sort,
  the payload extract), then `_decode_tail`; the only route that gives
  the prob outputs;
  chunk_mode="fused": the whole chunk in one kernel (ops/fused_chunk.py);
  knn_mode="fused", chunk_mode="xla" (the staged path): the candidate
  selection kernel (ops/fused_select.py), the decode tail in torch
  (`_decode_tail`), and the tower either as the K-accumulating decode
  kernel (ops/fused_decode.py, AggregatorConfig.fused_decode2 with an
  eligible config) or as `decode_radiance`.

With `QueryConfig.march_steps` the front-end is the distance-field ray
march instead (ops/march.py; the CUDA walk `csrc/march.cu`): it emits
each ray's first min(SR, BP) occupied samples directly, so the qslot
table, the depth window and the column selection drop out (mc_overflow
takes dw_overflow's place). `premarch` hands a chunk the same packed
rows from the frame-level raster (ops/raster.py), and the walk is
skipped too. `render_frame` renders a whole frame: rays sorted on the
host (box hits first, ascending span), chunks at the smallest
depth-window tier, the compaction budget escalated where it overflowed,
and, for a pinhole pixel grid (`raster=`), one raster program per frame
in place of the per-chunk march.

On a sparse grid (ops/hash_grid.py; `make_hash_fast_scene`) the cache
carries the bucket table in place of the dense qslot table: the
front-end looks each sample's voxel up there, the box is the grid's
logical dims, and, as in the reference, only the XLA route serves it
(the fused chunk and the selection kernel read no hash cache there
either; the march and the raster need dense tables). `bg_ray_colors`
(the plane model's per-ray background, models/bg_plane.py) replaces
cfg.bg_color where given.

Not ported yet: `cand_prune` on the XLA route, the "krows" extract,
span tiers, coarse windows, pair decode and sharding; a config that asks
for them raises.

Host synchronisation: none per chunk on the kernel routes (ray packing
and slot packing are cumsum/scatter compactions on the device, and the
kernels skip masked slots themselves); the XLA route reads the valid
slot count back once per call, to skip its all-padding chunks as the
reference's `chunk_or_skip` does.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import (
    Aggregator, aggregation_weight, decode_radiance)
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.ops.camera import neighbor_dists, rotate, w2pers
from pointnerf2studio_torch.ops.compositing import (
    BLEND_FUNCTIONS, TONE_MAPS, packed_alpha_composite, ray_dist_from_sample_z)
from pointnerf2studio_torch.ops.fused_chunk import (
    PK, fused_chunk_decode, fused_chunk_eligible)
from pointnerf2studio_torch.ops.fused_decode import (
    fused_decode2, fused_decode_served, tower_inputs)
from pointnerf2studio_torch.ops.fused_select import fused_candidate_select
from pointnerf2studio_torch.ops.grid import PointGrid
from pointnerf2studio_torch.ops.hash_grid import W as HASH_W
from pointnerf2studio_torch.ops.hash_grid import (
    HashGrid, hash_lookup, table_qslot)
from pointnerf2studio_torch.ops.march import (
    build_march_table, march_rays, slab, to_i32)
from pointnerf2studio_torch.ops.query import (
    layered_k_nearest, neighbor_offsets)
from pointnerf2studio_torch.ops.raster import (
    RasterUnserved, _voxel_footprint, build_qvox, make_raster_program)
from pointnerf2studio_torch.ops.select import (
    rank_gather_pack, select_first_cols)

PAYW = 44                 # bf16 payload per candidate: xyz_rel(3) +
                          # emb(32) + conf(1) + dir(3) + color(3) + pad(2)
ROWW = 1 + PAYW // 2      # f32 words per candidate in the reference's
                          # "rows" layout (its cache sizing counts them)
TAIL_CHUNK = 1 << 16      # slots per piece of the decode_radiance tail


@dataclasses.dataclass
class FatCache:
    """Per-query-voxel candidate rows for the fast path (the content of
    the reference's layout="fused", stored candidate-major):

    kmeta [max_q, C] int32: pidx * 4 + shell, or -1 for an empty slot.
    kcand [max_q, C, PK] bf16, candidate-major and contiguous: per
    candidate its xyz RELATIVE to the query voxel's centre (3), embedding
    (32), conf (1), dir (3), colour (3), zero padding to PK = 48: 96
    contiguous bytes, three whole 32-byte sectors, so a kernel reads a
    chosen neighbour with 16-byte loads.
    kxyz [max_q, 3, C] bf16, contiguous: the three relative-xyz planes
    once more (6% of kcand's bytes), for the distance pass, which wants
    all C candidates of one axis in a row. Channels 0-2 stay in kcand too:
    the payload that leaves the selection carries them.
    `kpay` is the reference's logical layout [max_q, PK, C], channel-major,
    as a strided view of kcand: same values, no copy. The plain versions
    and the comparisons with the reference's cache read it.

    The reference's other layout, "rows" ([max_q, C * ROWW] f32: per
    candidate the meta word, then the first PAYW = 44 payload channels as
    22 bit-cast bf16 pairs), which its XLA candidate stages read, holds
    exactly kmeta and kcand[..., :PAYW]: the port's XLA route gathers
    those, and keeps no second copy of the cache.

    Candidates are ordered by (Chebyshev shell, distance to the voxel
    centre) as the reference's f32 key orders them.
    march_table [gx, gy, gz] int32 (ops/march.build_march_table): the
    qslot table packed with a Chebyshev distance field, present when the
    config routes the front-end through the march.
    On a sparse grid (ops/hash_grid.py; `build_fat_cache_hash`) the bucket
    table `hash_table` takes the place of coor_2_qslot (None), and
    `logical_dims` (host ints) bounds the voxel coordinates.
    """
    coor_2_qslot: Optional[torch.Tensor]   # [gx, gy, gz] int32, -1 = not
                                           # query; None on a hash grid
    kmeta: torch.Tensor            # [max_q, C] int32
    kcand: torch.Tensor            # [max_q, C, PK] bf16
    kxyz: torch.Tensor             # [max_q, 3, C] bf16
    n_q: torch.Tensor              # [] int32
    march_table: Optional[torch.Tensor] = None
    hash_table: Optional[torch.Tensor] = None      # [B, S * 5] int32
    logical_dims: Optional[Tuple[int, int, int]] = None

    @property
    def cand(self) -> int:
        return self.kmeta.shape[1]

    @property
    def max_q(self) -> int:
        return self.kmeta.shape[0]

    @property
    def kpay(self) -> torch.Tensor:
        return self.kcand.transpose(1, 2)


def cache_dims(cache) -> Tuple[int, int, int]:
    """The voxel bounds of a FatCache or a GeoCache: its qslot table's
    shape, or the logical dims of a hash grid's cache."""
    if cache.hash_table is not None:
        return tuple(cache.logical_dims)
    return tuple(cache.coor_2_qslot.shape)


def query_voxels(grid, max_q: int):
    """The query voxels of a grid (a PointGrid or an ops/hash_grid
    HashGrid) as the caches number them: (coor_2_qslot [gx, gy, gz] int32,
    -1 = not a query voxel, None on a hash grid; n_q [] int32; q_coor
    [max_q, 3] int64; q_live [max_q] bool; center_w [max_q, 3] f32, each
    voxel's centre). Both grids number query voxels in (x, y, z) order; a
    hash grid's come out of its bucket table (rows past n_q: coords -1)."""
    if isinstance(grid, HashGrid):
        dev = grid.table.device
        tbl = grid.table.reshape(-1, HASH_W)
        qv = tbl[:, 4].long()
        live = (tbl[:, 0] >= 0) & (qv >= 0) & (qv < max_q)
        q_coor = torch.full((max_q, 3), -1, dtype=torch.long, device=dev)
        q_coor[qv[live]] = tbl[live, :3].long()
        q_live = torch.zeros(max_q, dtype=torch.bool, device=dev)
        q_live[qv[live]] = True
        coor_2_qslot, n_q = None, grid.n_q
    else:
        dev = grid.coor_occ.device
        gx, gy, gz = grid.dims
        nvox = gx * gy * gz
        occ_flat = grid.coor_occ.reshape(-1)
        qslot = torch.cumsum(occ_flat.long(), 0) - 1
        n_q = occ_flat.sum().to(torch.int32)
        valid_q = occ_flat & (qslot < max_q)
        coor_2_qslot = torch.where(valid_q, qslot, -1).to(
            torch.int32).reshape(grid.dims)
        q_flat = torch.full((max_q,), nvox, dtype=torch.long, device=dev)
        live_ids = torch.nonzero(valid_q).squeeze(1)
        q_flat[:live_ids.shape[0]] = live_ids
        q_coor = torch.stack([q_flat // (gy * gz), (q_flat // gz) % gy,
                              q_flat % gz], -1)
        q_live = q_flat < nvox
    # one rounding of rmin + (q + 0.5) * svs, as the reference's compiled
    # build gets from a fused multiply-add; the relative xyz of both caches
    # inherit this value bit for bit
    center_w = (grid.ranges_min.double() + (q_coor.double() + 0.5)
                * grid.scaled_vsize.double()).float()
    return coor_2_qslot, n_q, q_coor, q_live, center_w


def _neighbour_slots(grid, nb: torch.Tensor) -> torch.Tensor:
    """The occupied slot of each neighbour voxel nb [..., 3] (-1: out of
    the grid or unoccupied): the dense coor_2_occ, or the hash table."""
    if isinstance(grid, HashGrid):
        return hash_lookup(grid, nb)[1]
    _, gy, gz = grid.dims
    dims_t = torch.tensor(grid.dims, device=nb.device)
    inb = ((nb >= 0) & (nb < dims_t)).all(-1)
    nbc = torch.minimum(torch.clamp(nb, min=0), dims_t - 1)
    slot = grid.coor_2_occ.reshape(-1)[
        (nbc[..., 0] * gy + nbc[..., 1]) * gz + nbc[..., 2]]
    return torch.where(inb, slot, -1)


def ordered_candidates(grid, xyz: torch.Tensor,
                       kernel_size: Tuple[int, int, int], C: int,
                       qc: torch.Tensor, cw: torch.Tensor,
                       live: torch.Tensor):
    """The first C candidates of each query voxel of a chunk (coordinates
    qc [B, 3], centres cw [B, 3], live [B]): (sel_ok [B, C] bool, sel_pidx
    [B, C] int64, sel_sh [B, C] int64 Chebyshev shell, sel_xyz [B, C, 3]).

    Candidate order is the reference's f32 key shell * 1e12 + min(d2,
    1e9), sorted stably: beyond shell 0 the d2 term is below one ulp of
    the shell term, so outer-shell candidates keep their scan order. Both
    caches (this module's and models/fast_train.py's) take it from here,
    on a dense grid or a hash grid alike."""
    dev = xyz.device
    offs_np, shells_np = neighbor_offsets(kernel_size)
    offsets = torch.as_tensor(offs_np, dtype=torch.long, device=dev)
    shells = torch.as_tensor(shells_np, dtype=torch.long, device=dev)
    V = offsets.shape[0]
    P = grid.occ_2_pnts.shape[1]
    N = xyz.shape[0]
    B = qc.shape[0]
    nb = qc[:, None, :] + offsets[None]                         # [B, V, 3]
    slot = _neighbour_slots(grid, nb)
    slot_ok = live[:, None] & (slot >= 0)
    cand = grid.occ_2_pnts[torch.where(slot_ok, slot, 0).long()]
    ok = slot_ok[..., None] & (cand >= 0)                       # [B, V, P]
    cxyz = xyz[torch.clamp(cand, 0, N - 1).long()]              # [B,V,P,3]
    dd = cxyz - cw[:, None, None, :]
    d2c = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] \
        + dd[..., 2] * dd[..., 2]
    okf = ok.reshape(B, V * P)
    sh = shells[None, :, None].expand(B, V, P).reshape(B, V * P)
    key = sh.float() * 1e12 + torch.clamp(d2c.reshape(B, V * P), max=1e9)
    key = torch.where(okf, key, float("inf"))
    top = torch.sort(key, dim=-1, stable=True).indices[:, :C]
    return (torch.gather(okf, 1, top),
            torch.gather(cand.reshape(B, V * P).long(), 1, top),
            torch.gather(sh, 1, top),
            torch.gather(cxyz.reshape(B, V * P, 3), 1,
                         top[..., None].expand(B, C, 3)))


def candidate_pieces(grid, xyz: torch.Tensor,
                     kernel_size: Tuple[int, int, int], C: int,
                     q_coor: torch.Tensor, center_w: torch.Tensor,
                     q_live: torch.Tensor, chunk: int):
    """(rows, ordered_candidates of those rows) for every query voxel of
    `query_voxels`, in pieces of `chunk` rows. The live voxels are a
    prefix; every row past them stands for the same voxel (q_flat = the
    voxel count), so their candidates are equal, and the last piece is
    one such row for the whole slice (it broadcasts on assignment)."""
    max_q = q_live.shape[0]
    n_live = int(q_live.sum())
    for s in range(0, n_live, chunk):
        e = min(s + chunk, n_live)
        yield slice(s, e), ordered_candidates(
            grid, xyz, kernel_size, C, q_coor[s:e], center_w[s:e],
            q_live[s:e])
    if n_live < max_q:
        e = n_live + 1
        yield slice(n_live, max_q), ordered_candidates(
            grid, xyz, kernel_size, C, q_coor[n_live:e],
            center_w[n_live:e], q_live[n_live:e])


def cand_width(grid, kernel_size: Tuple[int, int, int],
               cand_cap: int) -> int:
    """C = min(cand_cap, candidates a voxel's neighbourhood can hold)."""
    V = neighbor_offsets(kernel_size)[0].shape[0]
    return min(cand_cap, V * grid.occ_2_pnts.shape[1])


@torch.no_grad()
def build_fat_cache(grid, cloud: NeuralPointCloud,
                    kernel_size: Tuple[int, int, int], max_q: int,
                    cand_cap: int = 64, chunk: int = 32768) -> FatCache:
    """Build the candidate cache (see `FatCache`) of a PointGrid or a
    HashGrid, once per point/attribute change. Candidates in the order of
    `ordered_candidates`."""
    dev = cloud.xyz.device
    C = cand_width(grid, kernel_size, cand_cap)
    N = cloud.xyz.shape[0]
    coor_2_qslot, n_q, q_coor, q_live, center_w = query_voxels(grid, max_q)
    attrs = torch.cat([cloud.points_embeding, cloud.points_conf,
                       cloud.points_dir, cloud.points_color],
                      -1).to(torch.bfloat16)                    # [N, 39]
    kmeta = torch.empty((max_q, C), dtype=torch.int32, device=dev)
    kcand = torch.empty((max_q, C, PK), dtype=torch.bfloat16, device=dev)
    kxyz = torch.empty((max_q, 3, C), dtype=torch.bfloat16, device=dev)
    for sl, (sel_ok, sel_pidx, sel_sh, sel_xyz) in candidate_pieces(
            grid, cloud.xyz, kernel_size, C, q_coor, center_w, q_live, chunk):
        cw = center_w[sl][:sel_ok.shape[0]]
        B = cw.shape[0]
        rel = (sel_xyz - cw[:, None, :]).to(torch.bfloat16)     # [B, C, 3]
        kmeta[sl] = torch.where(sel_ok, sel_pidx * 4 + sel_sh,
                                -1).to(torch.int32)
        sel_attr = attrs[torch.clamp(sel_pidx, 0, N - 1)]       # [B, C, 39]
        kcand[sl] = torch.cat([rel, sel_attr, rel.new_zeros((B, C, PK - 42))],
                              -1)
        kxyz[sl] = rel.transpose(1, 2)
    hashed = isinstance(grid, HashGrid)
    return FatCache(coor_2_qslot=coor_2_qslot, kmeta=kmeta, kcand=kcand,
                    kxyz=kxyz, n_q=n_q,
                    hash_table=grid.table if hashed else None,
                    logical_dims=grid.dims if hashed else None)


def build_fat_cache_hash(hg: HashGrid, cloud: NeuralPointCloud,
                         kernel_size: Tuple[int, int, int], max_q: int,
                         cand_cap: int = 64, chunk: int = 32768) -> FatCache:
    """The fat cache over a sparse HashGrid (large-extent scenes): the
    rows of `build_fat_cache` (the hash grid's qslots are the dense
    grid's (x, y, z) ranks, and the candidates come in the same order
    with the same packing), so on a scene where both grids fit the two
    caches' first n_q rows are equal bit for bit; only the front-end's
    voxel -> qslot lookup differs (the bucket table for the dense
    table)."""
    return build_fat_cache(hg, cloud, kernel_size, max_q, cand_cap, chunk)


def fit_cand_cap(max_q: int, cand_cap: int,
                 budget_bytes: Optional[int] = None,
                 device: torch.device | str | None = None,
                 row_words: int = ROWW, what: str = "fat cache") -> int:
    """Halve cand_cap (floor 8) until max_q * cand_cap * row_words * 4
    bytes (the reference's sizing) fit the budget: 60% of the CUDA
    device's memory (torch.cuda.mem_get_info), or of 16 GiB for other
    devices."""
    if budget_bytes is None:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            budget_bytes = int(torch.cuda.mem_get_info(dev)[1] * 0.6)
        else:
            budget_bytes = int((16 << 30) * 0.6)
    row = row_words * 4
    cc = cand_cap
    while cc > 8 and max_q * cc * row > budget_bytes:
        cc //= 2
    if max_q * cc * row > budget_bytes:
        raise ValueError(
            f"{what} infeasible: {max_q} query voxels x cand_cap {cc} x "
            f"{row} B = {max_q * cc * row / 2 ** 30:.1f}"
            f" GiB exceeds the {budget_bytes / 2 ** 30:.1f} GiB budget "
            f"even at the minimum candidate width; coarsen vsize")
    if cc != cand_cap:
        print(f"{what}: cand_cap {cand_cap} -> {cc} to fit {max_q} query "
              f"voxels in {budget_bytes / 2 ** 30:.1f} GiB (degraded "
              f"exactness: dense neighbourhoods truncate to the {cc} "
              f"nearest-to-centre per shell)")
    return cc


def make_fast_scene(cfg: PointNerfConfig, cloud: NeuralPointCloud,
                    grid: PointGrid, max_q: Optional[int] = None):
    """Build the fat cache for a scene; returns (cache, ranges_min,
    scaled_vsize). max_q defaults to the query-voxel count rounded up
    to a multiple of 32768."""
    q = cfg.query
    if q.cand_prune and "fused" not in (q.knn_mode, q.chunk_mode):
        # the reference prunes the candidates of its XLA route only
        raise NotImplementedError(
            "cand_prune on the XLA route is not ported (ROADMAP queue 1 "
            "item 5)")
    if max_q is None:
        nq = int(grid.coor_occ.sum())
        max_q = (nq + 32767) // 32768 * 32768
    cc = fit_cand_cap(max_q, q.cand_cap, device=cloud.xyz.device)
    cache = build_fat_cache(grid, cloud, q.kernel_size, max_q, cc)
    if march_active(q):
        cache.march_table = build_march_table(cache.coor_2_qslot)
    return cache, grid.ranges_min, grid.scaled_vsize


def make_hash_fast_scene(cfg: PointNerfConfig, cloud: NeuralPointCloud,
                         hg: HashGrid, max_q: Optional[int] = None):
    """Build the fat cache over a sparse HashGrid; returns (cache,
    ranges_min, scaled_vsize), as make_fast_scene does for a dense grid.
    max_q defaults to n_q rounded up to a multiple of 32768. As in the
    reference, `coarse_step` and knn_mode="fused" are dense-only (the
    fused chunk, which reads no hash cache in the reference either, is
    refused by fast_render_rays), there is no march table, and
    `cand_prune` does not apply (the reference's hash cache keeps every
    candidate)."""
    q = cfg.query
    if q.coarse_step > 1:
        raise NotImplementedError(
            "coarse_step needs a dense coarse-occupancy grid; off in hash "
            "mode")
    if q.knn_mode == "fused":
        raise NotImplementedError("knn_mode='fused' is dense-only")
    if max_q is None:
        nq = int(hg.n_q)
        max_q = (nq + 32767) // 32768 * 32768
    cc = fit_cand_cap(max_q, q.cand_cap, device=cloud.xyz.device,
                      what="hash fat cache")
    cache = build_fat_cache_hash(hg, cloud, q.kernel_size, max_q, cc)
    return cache, hg.ranges_min, hg.scaled_vsize


@dataclasses.dataclass
class FastRenderOutput:
    coarse_raycolor: torch.Tensor          # [R, 3]
    ray_mask: torch.Tensor                 # [R] bool
    acc: torch.Tensor                      # [R]
    depth: torch.Tensor                    # [R]
    # in-box samples past the depth window (None when the clip is off)
    dw_overflow: Optional[torch.Tensor] = None
    # box-hitting rays past ray_budget (None when packing is off)
    rb_overflow: Optional[torch.Tensor] = None
    # valid samples past M = R * compact_budget (None when M cannot
    # overflow)
    cb_overflow: Optional[torch.Tensor] = None
    # march front-end only: rays whose in-box span was not fully tested
    # within the staged fuel and buckets (non-zero: raise march_steps /
    # march_buckets, samples may be missing). None when the march is off
    # or a raster emit table (`premarch`) took the walk's place.
    mc_overflow: Optional[torch.Tensor] = None
    # valid compacted sample slots (the rows the tower shades)
    n_valid_slots: Optional[torch.Tensor] = None
    # render_frame only: the front-end that produced the frame's samples,
    # "raster", "march" or "depth_window"
    front_end: Optional[str] = None
    # prob=True only (point growing): per ray, the shading slot of largest
    # opacity (the first among equals), its location and the weight * conf
    # neighbour averages there. None unless prob=True.
    ray_max_shading_opacity: Optional[torch.Tensor] = None   # [R]
    ray_max_sample_loc_w: Optional[torch.Tensor] = None      # [R, 3]
    shading_avg_color: Optional[torch.Tensor] = None         # [R, 3]
    shading_avg_dir: Optional[torch.Tensor] = None           # [R, 3]
    shading_avg_conf: Optional[torch.Tensor] = None          # [R, 1]
    shading_avg_embedding: Optional[torch.Tensor] = None     # [R, F]


PROB_FIELDS = ("ray_max_shading_opacity", "ray_max_sample_loc_w",
               "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
               "shading_avg_embedding")


def march_active(q) -> bool:
    """Whether this query config routes the front-end through the
    distance-field ray march (ops/march.py). Config-only; the render
    raises if a march config meets a cache without a march table."""
    return (len(q.march_steps) > 0 and not q.span_tiers
            and q.coarse_step <= 1 and q.compact_mode == "topk")


def has_cb_overflow(q) -> bool:
    """Whether fast_render_rays emits a cb_overflow counter for this
    query config (the M = R * compact_budget cap can drop samples)."""
    D = q.z_depth_dim
    SR = q.SR
    BP = q.ray_slot_budget or min(SR, 32)
    budget = q.compact_budget if q.compact_budget > 0 else SR
    if march_active(q):
        # the march emits up to min(SR, BP) samples over the full D
        Dax = D
    elif q.depth_window > 0:
        Dax = min(q.depth_window, D)
    else:
        Dax = D
    return min(budget, D) < min(SR, BP, Dax)


def _use_fused2(cfg: PointNerfConfig) -> bool:
    """The K-accumulating decode kernel runs where the config asks for
    it and the tower is one it implements (the reference also wants a
    TPU backend; the port has no such test)."""
    return cfg.agg.fused_decode2 and fused_decode_served(
        cfg.agg, False, cfg.query.K)


def _check_served(cfg: PointNerfConfig, Rw2c: torch.Tensor) -> str:
    """"chunk" (the fused chunk kernel), "staged" (select kernel + decode
    tail) or "xla" (the XLA candidate stages + decode tail) for a config
    the port serves; raises otherwise."""
    q = cfg.query
    whole = (q.chunk_mode == "fused" and not _use_fused2(cfg)
             and fused_chunk_eligible(cfg.agg, Rw2c.ndim == 4, q.K))
    staged = q.chunk_mode == "xla" and q.knn_mode == "fused"
    xla = (q.chunk_mode == "xla" and q.knn_mode == "xla"
           and q.extract_mode in ("onehot", "gather"))
    unported = {
        "span_tiers": bool(q.span_tiers), "coarse_step": q.coarse_step > 1,
        "compact_mode": q.compact_mode != "topk",
        "composite_mode": q.composite_mode != "packed",
        "chunk_mode/knn_mode/extract_mode/agg": not (whole or staged or xla),
        "decode_mode": q.decode_mode != "lanes",
        "base_cache": q.base_cache,
        "per-point Rw2c": Rw2c.ndim != 2,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"fast_render_rays: not ported for this config ({bad}); the "
            f"port serves depth_window/ray_budget or march_steps + topk "
            f"compaction + packed composite + decode_mode='lanes' with "
            f"knn_mode='xla', chunk_mode='xla' and extract_mode 'onehot' "
            f"or 'gather', with chunk_mode='fused' (an "
            f"eligible aggregator, fused_decode2 off) or with "
            f"knn_mode='fused', chunk_mode='xla'")
    return "chunk" if whole else "staged" if staged else "xla"


def _decode_tail(params: Aggregator, cfg: PointNerfConfig, Rw2c, camrotc2w,
                 campos, nsel, pnt_mask, locs, center, rd_sel,
                 want_attrs: bool = False):
    """(sigma [M], rgb [M, 3], found [M]) from the selected payloads
    nsel [M, K, >= 42] bf16: neighbour geometry, aggregation weights,
    then the tower (the reference's `_decode_tail`). `want_attrs` adds
    the [M, 39] weight * conf neighbour averages of the prob outputs
    (colour 3, dir 3, conf 1, embedding 32), with the wc = weight * conf
    * pnt_mask of the legacy prob path."""
    f32 = torch.float32
    nxyz = nsel[..., :3].to(f32) + center[:, None, :]           # [M, K, 3]
    # attribute slices stay bf16 end to end, as in the reference
    emb = nsel[..., 3:35]
    conf = nsel[..., 35].to(f32)
    ndir = nsel[..., 36:39]
    ncol = nsel[..., 39:42]
    dists = neighbor_dists(nxyz, locs, camrotc2w, campos)
    weight, emb2 = aggregation_weight(cfg.agg, emb, dists, pnt_mask,
                                      max(cfg.query.scaled_vsize), params)
    if cfg.agg.conf_in_weight:
        weight = weight * conf
    vd = rotate(rd_sel, Rw2c)
    if _use_fused2(cfg):
        dists_rot, dirdot, wk, dir_pe = tower_inputs(
            cfg.agg, dists, ndir, vd, weight, pnt_mask, Rw2c)
        sig, rgb = fused_decode2(
            params, emb2, dists_rot, ncol, dirdot, wk, dir_pe,
            cfg.agg.num_feat_freqs, cfg.agg.num_dist_freqs)
    else:
        sig, rgb = decode_radiance(
            params, cfg.agg, neigh_emb=emb2, neigh_color=ncol,
            neigh_dir=ndir, dists=dists, weight=weight, pnt_mask=pnt_mask,
            viewdirs=vd, Rw2c=Rw2c)
    if not want_attrs:
        return sig, rgb, pnt_mask.any(-1)
    wc = (weight * conf * pnt_mask.to(weight.dtype))[..., None].to(f32)
    attrs = torch.cat([(ncol.to(f32) * wc).sum(-2),
                       (ndir.to(f32) * wc).sum(-2),
                       (conf[..., None] * wc).sum(-2),
                       (emb.to(f32) * wc).sum(-2)], -1)
    return sig, rgb, pnt_mask.any(-1), attrs


def _xla_chunk(params: Aggregator, cfg: PointNerfConfig, Rw2c, camrotc2w,
               campos, kmeta, kcand, qslot, locs, center, rd_sel, mask,
               num_shells: int, want_attrs: bool):
    """The reference's XLA chunk body (`chunk_pipeline`, knn_mode and
    chunk_mode "xla") on Mc slots, as torch ops: the fat-row gather by
    qslot [Mc] (kmeta and kcand's first PAYW channels, the words of the
    reference's rows), candidate d2 from the bf16 relative xyz plus
    `center - locs`, the valid / radius masks, the layered K smallest d2
    (`layered_k_nearest`: valid first, smallest column on ties), the
    payload extract (a gather under pnt_mask, which equals the reference's
    one-hot einsum: one bf16 value passes its f32 accumulator unchanged),
    then `_decode_tail`."""
    q = cfg.query
    K = q.K
    Mc = qslot.shape[0]
    meta = kmeta[qslot]                                         # [Mc, C]
    # the candidate rows move as 8-byte words (a bf16 index copy moves
    # two bytes an element)
    payload = kcand.view(torch.int64).index_select(0, qslot).view(
        torch.bfloat16)                                         # [Mc, C, PK]
    cd = center - locs
    dx = payload[..., 0].float() + cd[:, 0:1]
    dy = payload[..., 1].float() + cd[:, 1:2]
    dz = payload[..., 2].float() + cd[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    ok = (meta >= 0) & mask[:, None]
    radius2 = q.radius_limit ** 2
    if radius2 > 0:
        ok = ok & (d2 <= radius2)
    top, pnt_mask = layered_k_nearest(d2, ok, meta & 3, K, num_shells)
    nsel = torch.gather(payload, 1, top[..., None].expand(Mc, K, PAYW))
    nsel = torch.where(pnt_mask[..., None], nsel, torch.zeros_like(nsel))
    return _decode_tail(params, cfg, Rw2c, camrotc2w, campos, nsel,
                        pnt_mask, locs, center, rd_sel, want_attrs)


def xla_chunk_slots(q, M: int) -> int:
    """CH, the slots of one chunk of the XLA route: the reference's
    max(min(fast_chunk or 8192, decode_chunk or M, M), min(2048, M))."""
    return max(min(q.fast_chunk or 8192, q.decode_chunk or M, M),
               min(2048, M))


def pack_hit_rays(cache, campos, raydirs, near, far, q, ranges_min,
                  scaled_vsize, jitter: float = 0.0):
    """Ray packing of one chunk: (ray_ids [RB] long, valid [RB] bool,
    rb_overflow [] int32) for RB = min(q.ray_budget, R). `ray_ids` holds
    the first RB box-hitting rays in ray order (cumsum + scatter, no
    sync); the padding rows repeat ray 0, as in the reference, and are
    False in `valid`. `jitter` (the train path's) widens the far margin
    by jitter/2 * (far - near): jittered segment lengths sum past far.
    `cache` is a FatCache or a GeoCache (its voxel bounds, `cache_dims`,
    size the box)."""
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    RB = min(q.ray_budget, R)
    near = torch.as_tensor(near, dtype=f32, device=dev)
    far = torch.as_tensor(far, dtype=f32, device=dev)
    step_t = (far - near) / q.z_depth_dim
    dims_f = torch.tensor(cache_dims(cache), device=dev).to(f32)
    rmax = ranges_min + dims_f * scaled_vsize
    t_enter, t_exit = slab(raydirs, campos, ranges_min, rmax)
    far_slack = jitter * 0.5 * (far - near) + step_t if jitter else step_t
    hit = ((t_exit + step_t >= t_enter) & (t_exit >= near - step_t)
           & (t_enter <= far + far_slack))
    pos = torch.cumsum(hit.long(), 0) - 1
    dest = torch.where(hit & (pos < RB), pos, RB)
    ray_ids = torch.zeros(RB + 1, dtype=torch.long, device=dev).scatter_(
        0, dest, torch.arange(R, device=dev))[:RB]
    n_hit = hit.sum()
    valid = torch.arange(RB, device=dev) < n_hit
    rb_overflow = torch.clamp(n_hit - RB, min=0).to(torch.int32)
    return ray_ids, valid, rb_overflow


def qslot_lookup(cache, pos: torch.Tensor, ranges_min: torch.Tensor,
                 scaled_vsize: torch.Tensor) -> torch.Tensor:
    """The qslot of the voxel each position [..., 3] lies in, -1 outside
    the grid or outside every query voxel: a gather from the dense qslot
    table of `cache` (a FatCache or a GeoCache), or its hash table's
    lookup (the reference's `_qs_lookup`)."""
    dims = cache_dims(cache)
    dims_t = torch.tensor(dims, device=pos.device)
    gc = torch.floor((pos - ranges_min) / scaled_vsize).to(torch.int32)
    inb = ((gc >= 0) & (gc < dims_t)).all(-1)
    if cache.hash_table is not None:
        return table_qslot(cache.hash_table, gc, inb)
    gcc = torch.minimum(torch.clamp(gc, min=0), dims_t - 1).long()
    fi = (gcc[..., 0] * dims[1] + gcc[..., 1]) * dims[2] + gcc[..., 2]
    qslot_flat = cache.coor_2_qslot.reshape(-1)
    return torch.where(inb, qslot_flat[torch.where(inb, fi, 0)], -1)


def march_args(cache: FatCache, campos, raydirs, near, far, q, ranges_min,
               scaled_vsize, ray_live=None) -> dict:
    """The keyword arguments `fast_render_rays` gives `march_rays` for
    these rays under query config `q`; raises where the cache or the
    packing cannot serve the walk."""
    if cache.hash_table is not None:
        raise ValueError(
            "march_steps needs a dense grid: a hash grid's cache has no "
            "march table (make_hash_fast_scene builds none)")
    if cache.march_table is None:
        raise ValueError(
            "march_steps needs a cache with march_table "
            "(make_fast_scene builds it when march_steps is set)")
    D = q.z_depth_dim
    if cache.max_q > (1 << 22) - 2 or D > 512:
        raise ValueError("march packing needs max_q < 2^22 - 1 and "
                         "z_depth_dim <= 512")
    dev = raydirs.device
    dims = cache.coor_2_qslot.shape
    near = torch.as_tensor(near, dtype=torch.float32, device=dev)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev)
    BP = q.ray_slot_budget or min(q.SR, 32)
    return dict(
        table_flat=cache.march_table.reshape(-1),
        dims_arr=torch.tensor(dims, dtype=torch.int32, device=dev),
        gy=dims[1], gz=dims[2], ranges_min=ranges_min,
        scaled_vsize=scaled_vsize, campos=campos,
        raydirs=raydirs.contiguous(), near=near, far=far,
        step_t=(far - near) / D, D=D, cap=min(q.SR, BP, D),
        steps=q.march_steps, buckets=q.march_buckets, live=ray_live)


@torch.no_grad()
def fast_render_rays(
    params: Aggregator,
    Rw2c: torch.Tensor,             # [3, 3] global rotation
    cache: FatCache,
    campos: torch.Tensor,           # [3]
    camrotc2w: torch.Tensor,        # [3, 3]
    raydirs: torch.Tensor,          # [R, 3]
    near,
    far,
    cfg: PointNerfConfig,
    ranges_min: torch.Tensor,       # [3]
    scaled_vsize: torch.Tensor,     # [3]
    ray_live: Optional[torch.Tensor] = None,    # [R] bool: rows that carry
                                    # real rays (ray packing pads with
                                    # copies of row 0; the march must not
                                    # walk them)
    premarch=None,                  # [R, cap] packed (qslot + 1) << 9 | d
                                    # emit rows of ops/raster, or (frame
                                    # emit table [HW, cap], this chunk's
                                    # frame ray ids [R]); takes the walk's
                                    # place when march_active(q)
    prob: bool = False,             # the prob outputs for point growing
                                    # (XLA route only; slot-grid composite)
    bg_ray_colors: Optional[torch.Tensor] = None,   # [R, 3] per-ray
                                    # background (the plane model's) in
                                    # place of cfg.bg_color
) -> FastRenderOutput:
    """Render R rays through the fast path (see the module docstring)."""
    route = _check_served(cfg, Rw2c)
    q = cfg.query
    if prob and route != "xla":
        raise ValueError(
            "prob-mode neighbour averages need the XLA route (knn_mode and "
            "chunk_mode 'xla', decode_mode 'lanes', extract_mode 'onehot' "
            "or 'gather')")
    if cache.hash_table is not None:
        # the reference's hash cache has no kernel-facing layout, and its
        # knn_mode="fused" is dense-only
        if route == "chunk":
            raise ValueError(
                "chunk_mode='fused' needs the kernel-facing cache layout, "
                "which a hash grid's cache does not serve")
        if route == "staged":
            raise NotImplementedError("knn_mode='fused' is dense-only")
    if isinstance(premarch, tuple):
        table, ids = premarch
        premarch = table[ids.long()]
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    D = q.z_depth_dim
    SR, K = q.SR, q.K
    BP = q.ray_slot_budget or min(SR, 32)
    budget = q.compact_budget if q.compact_budget > 0 else SR
    M = min(R * budget, R * D)
    dims_f = torch.tensor(cache_dims(cache), device=dev).to(f32)
    near = torch.as_tensor(near, dtype=f32, device=dev)
    far = torch.as_tensor(far, dtype=f32, device=dev)
    step_t = (far - near) / D
    rmax = ranges_min + dims_f * scaled_vsize
    bg = (bg_ray_colors.to(f32) if bg_ray_colors is not None
          else torch.as_tensor(cfg.bg_color, dtype=f32,
                               device=dev).expand(R, 3))

    if q.ray_budget > 0:
        # ---- ray packing: only box-hitting rays enter the front-end.
        # A ray whose chord misses the box renders exact background,
        # so this is exact while rb_overflow == 0. Ordered compaction
        # of the first RB hitting rays (cumsum + scatter, no sync); the
        # padding rows repeat ray 0, as in the reference.
        ray_ids, valid, rb_overflow = pack_hit_rays(
            cache, campos, raydirs, near, far, q, ranges_min, scaled_vsize)
        cfg0 = dataclasses.replace(cfg, query=dataclasses.replace(
            q, ray_budget=0))
        sub = fast_render_rays(params, Rw2c, cache, campos, camrotc2w,
                               raydirs[ray_ids], near, far, cfg0,
                               ranges_min, scaled_vsize, ray_live=valid,
                               premarch=(None if premarch is None
                                         else premarch[ray_ids]), prob=prob,
                               bg_ray_colors=(None if bg_ray_colors is None
                                              else bg_ray_colors[ray_ids]))
        ids = torch.where(valid, ray_ids, R)       # padding rows drop

        def scatter(base, x):
            out = torch.cat([base, base[:1]])
            out[ids] = x.to(base.dtype)
            return out[:R]

        # miss rays keep zeros (opacity 0) in the prob outputs
        prob_kw = {f: scatter(torch.zeros((R,) + getattr(sub, f).shape[1:],
                                          dtype=getattr(sub, f).dtype,
                                          device=dev), getattr(sub, f))
                   for f in PROB_FIELDS} if prob else {}
        return FastRenderOutput(
            coarse_raycolor=scatter(bg.contiguous(), sub.coarse_raycolor),
            ray_mask=scatter(torch.zeros(R, dtype=torch.bool, device=dev),
                             sub.ray_mask),
            acc=scatter(torch.zeros(R, dtype=f32, device=dev), sub.acc),
            depth=scatter(torch.zeros(R, dtype=f32, device=dev), sub.depth),
            dw_overflow=sub.dw_overflow, rb_overflow=rb_overflow,
            cb_overflow=sub.cb_overflow, mc_overflow=sub.mc_overflow,
            n_valid_slots=sub.n_valid_slots, **prob_kw)

    def qs_lookup(pos):
        return qslot_lookup(cache, pos, ranges_min, scaled_vsize)

    mc_overflow = dw_overflow = None
    if march_active(q):
        # ---- distance-field ray march (ops/march.py): tests about the
        # samples a sphere trace visits instead of the dense [R, D(W)]
        # table, and emits each ray's first-cap occupied samples directly,
        # so the column selection below is skipped too. Exact while
        # mc_overflow == 0. With `premarch` the walk is skipped as well:
        # the frame-level raster already binned these rays' first-cap
        # samples in the same packed format (exact while the raster's
        # counters read zero, which the caller checks per frame).
        cap = min(SR, BP, D)
        if premarch is not None:
            if tuple(premarch.shape) != (R, cap):
                raise ValueError(
                    f"premarch shape {tuple(premarch.shape)} != {(R, cap)}")
            if cache.max_q > (1 << 22) - 2:
                raise ValueError("premarch packing needs max_q < 2^22 - 1")
            emit = premarch
            cnt = (premarch != 0).sum(-1).to(torch.int32)
            if ray_live is not None:
                cnt = torch.where(ray_live, cnt, 0)
        else:
            emit, cnt, mc_overflow = march_rays(**march_args(
                cache, campos, raydirs, near, far, q, ranges_min,
                scaled_vsize, ray_live=ray_live))
        ray_hit = cnt > 0
        iota = torch.arange(cap, dtype=torch.int32, device=dev).expand(R, cap)
        sel_ray, sel_slot, _, _, packed_m, mask_c = rank_gather_pack(
            emit, iota, cnt, M)
        qslot_c = torch.clamp((packed_m >> 9) - 1, min=0)
        sel_d = packed_m & 511
        Dax = D
    elif q.depth_window > 0:
        # ---- per-ray depth window: the lookup domain is [R, DW]
        # samples from the ray's slab entry; exact while DW covers each
        # ray's in-box span (dw_overflow counts the dropped samples)
        DW = min(q.depth_window, D)
        t_enter, t_exit = slab(raydirs, campos, ranges_min, rmax)
        # to_i32: a ray nearly parallel to a slab has |t_enter| past
        # int32, where the cast differs between devices
        d_lo = to_i32(torch.floor((t_enter - near) / step_t - 0.5))
        d0 = torch.clamp(d_lo, 0, max(D - DW, 0))
        d_hi = torch.clamp(to_i32(torch.ceil(
            (torch.minimum(t_exit, far) - near) / step_t - 0.5)), max=D - 1)
        hit_box = (t_exit >= t_enter) & (d_hi >= 0)
        dw_overflow = torch.where(
            hit_box, torch.clamp(d_hi - (d0 + DW - 1), min=0),
            0).sum().to(torch.int32)
        d_true = d0[:, None] + torch.arange(DW, device=dev, dtype=torch.int32)
        t_f = near + (d_true.to(f32) + 0.5) * step_t
        qs = qs_lookup(campos + raydirs[:, None, :] * t_f[..., None])
        Dax = DW
    else:
        t_mid = near + (torch.arange(D, device=dev, dtype=f32) + 0.5) * step_t
        qs = qs_lookup(campos + raydirs[:, None, :] * t_mid[None, :, None])
        d0 = torch.zeros(R, dtype=torch.int32, device=dev)
        Dax = D
    if not march_active(q):
        # ---- first min(SR, BP) valid columns per ray, packed to M slots
        qs = qs.to(torch.int32).contiguous()
        col_sel, cnt, ray_hit = select_first_cols(qs, BP, min(SR, BP, Dax),
                                                  q.select_mode)
        sel_ray, sel_slot, colm, _, qslot_c, mask_c = rank_gather_pack(
            qs, col_sel, cnt, M)
        sel_d = d0.long()[sel_ray] + colm
    pack_end = torch.cumsum(cnt.long(), 0)
    cb_overflow = (torch.clamp(pack_end[-1] - M, min=0).to(torch.int32)
                   if M < R * min(SR, BP, Dax) else None)

    rd_sel = raydirs[sel_ray]
    t_sel = near + (sel_d.to(f32) + 0.5) * step_t
    locs = campos + rd_sel * t_sel[:, None]
    vox = torch.floor((locs - ranges_min) / scaled_vsize)
    center = ranges_min + (vox + 0.5) * scaled_vsize
    num_shells = (q.kernel_size[0] + 1) // 2 if q.layered_search else 1
    qslot_i = qslot_c.to(torch.int32)
    if route == "chunk":
        # ---- selection + tower per slot in one kernel launch
        sig, rgb, found = fused_chunk_decode(
            params, Rw2c, camrotc2w, campos, cache.kmeta, cache.kcand,
            cache.kxyz, qslot_i, locs.contiguous(), center.contiguous(),
            rd_sel.contiguous(), mask_c, K=K, radius2=q.radius_limit ** 2,
            num_shells=num_shells,
            nff=cfg.agg.num_feat_freqs, ndf=cfg.agg.num_dist_freqs,
            nvf=cfg.agg.num_viewdir_freqs, act_super=cfg.agg.act_super)
    elif route == "staged":
        # ---- staged: the select kernel, then the decode tail. Under
        # decode_radiance the tail runs in pieces of TAIL_CHUNK slots:
        # every stage is per slot, so the pieces change no result; they
        # bound the [M, K, 284] feature and its PE intermediates
        nsel, pnt_mask = fused_candidate_select(
            cache.kmeta, cache.kcand, cache.kxyz, qslot_i,
            (center - locs).contiguous(), mask_c, K, q.radius_limit ** 2,
            num_shells)
        piece = max(M, 1) if _use_fused2(cfg) else TAIL_CHUNK
        tails = [_decode_tail(params, cfg, Rw2c, camrotc2w, campos,
                              nsel[s:s + piece], pnt_mask[s:s + piece],
                              locs[s:s + piece], center[s:s + piece],
                              rd_sel[s:s + piece])
                 for s in range(0, M, piece)]
        sig, rgb, found = (torch.cat(x) for x in zip(*tails))
    else:
        # ---- XLA candidate stages, CH slots a chunk.
        # The valid slots are a prefix of the M axis; chunks past it are
        # all padding and are skipped (one read-back of the count).
        CH = xla_chunk_slots(q, M)
        n_valid = int(mask_c.sum())
        sig = torch.zeros(M, dtype=f32, device=dev)
        rgb = torch.zeros((M, 3), dtype=f32, device=dev)
        found = torch.zeros(M, dtype=torch.bool, device=dev)
        attrs_m = (torch.zeros((M, PAYW - 5), dtype=f32, device=dev)
                   if prob else None)
        for s in range(0, n_valid, CH):
            c = slice(s, s + CH)
            res = _xla_chunk(params, cfg, Rw2c, camrotc2w, campos,
                             cache.kmeta, cache.kcand, qslot_c[c], locs[c],
                             center[c], rd_sel[c], mask_c[c], num_shells,
                             prob)
            sig[c], rgb[c], found[c] = res[0], res[1], res[2]
            if prob:
                attrs_m[c] = res[3]

    slot_ok = mask_c & found
    sig = sig * slot_ok.to(sig.dtype)
    if prob:
        return _grid_composite_prob(
            cfg, sig, rgb, slot_ok, attrs_m, sel_ray, sel_slot, sel_d,
            ray_hit, raydirs, campos, camrotc2w, near, step_t, BP, bg,
            dict(dw_overflow=dw_overflow, cb_overflow=cb_overflow,
                 mc_overflow=mc_overflow,
                 n_valid_slots=mask_c.sum().to(torch.int32)))

    # ---- packed composite
    z_m = w2pers(locs, camrotc2w, campos)[..., 2]
    rgb_sum, acc, depth, ray_found = packed_alpha_composite(
        sig, rgb, z_m, slot_ok, sel_ray, pack_end, cnt, q.vsize[2],
        cfg.blend_func, max_slots=BP)
    color = rgb_sum + (1 - acc)[..., None] * bg
    color = TONE_MAPS[cfg.tonemap_func](color)
    ray_mask = ray_hit & ray_found
    color = torch.where(ray_mask[:, None], color, bg)
    return FastRenderOutput(
        coarse_raycolor=color, ray_mask=ray_mask, acc=acc, depth=depth,
        dw_overflow=dw_overflow, cb_overflow=cb_overflow,
        mc_overflow=mc_overflow, n_valid_slots=mask_c.sum().to(torch.int32))


def _grid_composite_prob(cfg, sig, rgb, slot_ok, attrs_m, sel_ray, sel_slot,
                         sel_d, ray_hit, raydirs, campos, camrotc2w, near,
                         step_t, BP, bg, counters) -> FastRenderOutput:
    """The reference's slot-grid composite with the prob outputs: the [M]
    slots scatter to [R, BP] (the per-ray opacity argmax needs the grid),
    alpha compositing per row, then each ray's slot of largest opacity
    (torch.argmax takes the first among equals, as jnp.argmax does), its
    location and the neighbour averages of that slot."""
    R = raydirs.shape[0]
    dev = raydirs.device
    dest = torch.where(slot_ok, sel_ray * BP + sel_slot, R * BP)

    def grid(x):
        g = torch.zeros((R * BP + 1,) + x.shape[1:], dtype=x.dtype,
                        device=dev)
        g[dest] = x
        return g[:R * BP].reshape((R, BP) + x.shape[1:])

    sig_rb, rgb_rb, valid_rb = grid(sig), grid(rgb), grid(slot_ok)
    d_rb = grid(sel_d.to(torch.int32))
    attrs_rb = grid(attrs_m)
    t_rb = near + (d_rb.to(torch.float32) + 0.5) * step_t
    pos_rb = campos + raydirs[:, None, :] * t_rb[..., None]
    z_rb = w2pers(pos_rb, camrotc2w, campos)[..., 2]
    z_masked = torch.where(valid_rb, z_rb, torch.full_like(z_rb, -1e9))
    dist = ray_dist_from_sample_z(z_masked, valid_rb, cfg.query.vsize[2])
    opacity = 1.0 - torch.exp(-sig_rb * dist)
    trans = torch.cumprod(1.0 - opacity + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    blend = BLEND_FUNCTIONS[cfg.blend_func](opacity, trans)
    acc = blend.sum(-1)
    color = (blend[..., None] * rgb_rb).sum(-2) + (1 - acc)[..., None] * bg
    color = TONE_MAPS[cfg.tonemap_func](color)
    depth = (blend * z_rb).sum(-1)
    ray_mask = ray_hit & valid_rb.any(-1)
    color = torch.where(ray_mask[:, None], color, bg)
    s_star = torch.argmax(opacity, -1)                           # [R]
    ar = torch.arange(R, device=dev)
    a_star = attrs_rb[ar, s_star]                                # [R, 39]
    return FastRenderOutput(
        coarse_raycolor=color, ray_mask=ray_mask, acc=acc, depth=depth,
        ray_max_shading_opacity=opacity[ar, s_star],
        ray_max_sample_loc_w=pos_rb[ar, s_star],
        shading_avg_color=a_star[:, 0:3], shading_avg_dir=a_star[:, 3:6],
        shading_avg_conf=a_star[:, 6:7], shading_avg_embedding=a_star[:, 7:],
        **counters)


def _np(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def suggest_depth_window(dims, scaled_vsize, near, far, D: int,
                         slack: int = 4) -> int:
    """Depth-window length covering ANY chord of the grid box: the box
    diagonal over the sample spacing, plus slack."""
    svs = _np(scaled_vsize, np.float64)
    diag = math.sqrt(sum((int(d) * float(v)) ** 2 for d, v in zip(dims, svs)))
    step = (float(far) - float(near)) / D
    return min(D, int(math.ceil(diag / step)) + slack)


def frame_ray_spans(campos, raydirs, near, far, D: int,
                    ranges_min, dims, scaled_vsize):
    """NumPy per-ray in-box sample spans (span [R] int64, hit [R] bool),
    by the slab test of fast_render_rays' depth window; `hit` is the
    conservative one-sample-margin test of its ray packing."""
    rd = _np(raydirs, np.float64)
    cp = _np(campos, np.float64).reshape(3)
    rmin = _np(ranges_min, np.float64).reshape(3)
    rmax = rmin + np.asarray(dims, np.float64) * _np(scaled_vsize,
                                                     np.float64)
    near, far = float(near), float(far)
    step = (far - near) / D
    safe = np.where(np.abs(rd) < 1e-9, np.where(rd >= 0, 1e-9, -1e-9), rd)
    inv = 1.0 / safe
    ta = (rmin - cp) * inv
    tb = (rmax - cp) * inv
    t_enter = np.minimum(ta, tb).max(-1)
    t_exit = np.maximum(ta, tb).min(-1)
    d_lo = np.floor((t_enter - near) / step - 0.5).astype(np.int64)
    d_hi = np.minimum(np.ceil((np.minimum(t_exit, far) - near) / step - 0.5),
                      D - 1).astype(np.int64)
    span_hit = (t_exit >= t_enter) & (d_hi >= 0)
    span = np.where(span_hit, d_hi - np.maximum(d_lo, 0) + 1, 0)
    hit = ((t_exit + step >= t_enter)
           & (t_exit >= near - step) & (t_enter <= far + step))
    return span, hit


def frame_ray_order(campos, raydirs, near, far, D: int, ranges_min, dims,
                    scaled_vsize):
    """(order [R] int64, n_hit, span [R]) of a frame's rays as
    `render_frame` renders them: box-hitting rays first, by ascending
    in-box span, miss rays last. A host planner (ops/march.plan_march)
    that sizes buckets for `render_frame`'s chunks takes its rays in this
    order."""
    span, hit = frame_ray_spans(campos, raydirs, near, far, D, ranges_min,
                                dims, scaled_vsize)
    return np.lexsort((span, ~hit)), int(hit.sum()), span


def measured_depth_window(campos, raydirs, near, far, D: int,
                          ranges_min, dims, scaled_vsize,
                          slack: int = 4) -> int:
    """Tight depth-window length for a known ray set: the max in-box
    span plus slack (dw_overflow == 0 re-verifies it on the device)."""
    span, _ = frame_ray_spans(campos, raydirs, near, far, D,
                              ranges_min, dims, scaled_vsize)
    return int(min(D, int(span.max(initial=0)) + slack))


def slab_hit_mask(campos, raydirs, near, far, D: int, ranges_min, dims,
                  scaled_vsize, jitter: float = 0.0) -> np.ndarray:
    """[R] bool: the rays ray packing treats as box-hitting (float32 slab
    test with the one-sample margin; `jitter` widens the far margin by
    jitter/2 * (far - near) for the train path)."""
    rd = _np(raydirs, np.float32)
    cp = _np(campos, np.float32).reshape(3)
    rmin = _np(ranges_min, np.float32).reshape(3)
    rmax = rmin + np.asarray(dims, np.float32) * _np(scaled_vsize,
                                                     np.float32)
    near, far = np.float32(near), np.float32(far)
    step = (far - near) / np.float32(D)
    safe = np.where(np.abs(rd) < 1e-9,
                    np.where(rd >= 0, np.float32(1e-9), np.float32(-1e-9)),
                    rd)
    inv = np.float32(1.0) / safe
    ta = (rmin - cp) * inv
    tb = (rmax - cp) * inv
    t_enter = np.minimum(ta, tb).max(-1)
    t_exit = np.maximum(ta, tb).min(-1)
    far_slack = np.float32(jitter) * np.float32(0.5) * (far - near) + step
    return ((t_exit + step >= t_enter)
            & (t_exit >= near - step) & (t_enter <= far + far_slack))


@torch.no_grad()
def frame_raster_emit(cache: FatCache, campos, camrotc2w, raydirs, near, far,
                      q, ranges_min, scaled_vsize, raster, pcache: dict):
    """(emit table [H*W, cap], ladder) of a frame from the raster front-end
    (ops/raster.py), the footprint ladder measured on this camera: `ladder`
    is (classes, class budgets, static rows). `pcache` keeps the scene's
    qvox table and the programs by ladder. Raises RasterUnserved where the
    raster does not serve the frame (a packing bound, the frame's shape, a
    camera inside or behind the grid box, a ladder past the row limit, a
    non-zero raster counter)."""
    Hr, Wr, foc = raster
    Rtot = raydirs.shape[0]
    D = q.z_depth_dim
    if Hr * Wr != Rtot:
        raise RasterUnserved(f"raster frame {Hr}x{Wr} != {Rtot}")
    qv = pcache.get(("raster_qvox", id(cache)))
    if qv is None:
        qv = build_qvox(cache.coor_2_qslot, cache.max_q)
        pcache[("raster_qvox", id(cache))] = qv
    dev = raydirs.device
    near_t = torch.tensor(float(near), dtype=torch.float32, device=dev)
    step_t = torch.tensor((float(far) - float(near)) / D,
                          dtype=torch.float32, device=dev)
    _, _, _, fw, fh, fnd, fok = _voxel_footprint(
        qv, ranges_min, scaled_vsize, campos, camrotc2w, Hr, Wr, foc,
        near_t, float(far), D, step_t)
    fok = fok.cpu().numpy()
    fw, fh, fnd = (a.cpu().numpy()[fok] for a in (fw, fh, fnd))
    if fw.size == 0 or fw.max() >= (1 << 30):
        raise RasterUnserved("camera inside/behind the grid box")
    # the ladder: footprint percentiles 55 / 80 / 95 and the maximum;
    # budgets in steps of 65,536 so that nearby frames share a program
    cls_l = [tuple(int(np.percentile(a, p)) for a in (fw, fh, fnd))
             for p in (55, 80, 95)]
    cls_l.append((int(fw.max()), int(fh.max()), int(fnd.max())))
    cls_l = tuple(dict.fromkeys(cls_l))
    rem = np.ones(fw.shape[0], bool)
    buds, rows_s = [], 0
    for (px, py, ndc) in cls_l:
        fits = rem & (fw <= px) & (fh <= py) & (fnd <= ndc)
        nb = -(-(int(fits.sum() * 1.2) + 2048) // 65536) * 65536
        buds.append(nb)
        rows_s += nb * px * py * ndc
        rem &= ~fits
    if rows_s > 40_000_000:
        raise RasterUnserved(f"emit ladder needs {rows_s:,} static rows")
    cap = min(q.SR, q.ray_slot_budget or min(q.SR, 32), D)
    pkey = ("raster_prog", Hr, Wr, cls_l, tuple(buds), cap)
    prog = pcache.get(pkey)
    if prog is None:
        prog = make_raster_program(Hr, Wr, foc, D, cap, classes=cls_l,
                                   class_budgets=tuple(buds),
                                   live_budget=4_194_304)
        pcache[pkey] = prog
    emit_tbl, ctrs = prog(qv, ranges_min, scaled_vsize, campos, camrotc2w,
                          raydirs, near_t, step_t)
    ctrs = ctrs.cpu().numpy()
    if ctrs.sum() != 0:
        raise RasterUnserved(f"raster counters {ctrs.tolist()}")
    return emit_tbl, (cls_l, tuple(buds), rows_s)


@torch.no_grad()
def render_frame(params: Aggregator, Rw2c, cache: FatCache, campos,
                 camrotc2w, raydirs, near, far, cfg: PointNerfConfig,
                 ranges_min, scaled_vsize, *, chunk: int = 65536,
                 dw_slack: int = 4, tier_quant: int = 32,
                 budget_tier: int = 0,
                 program_cache: Optional[dict] = None,
                 host_rays: Optional[np.ndarray] = None,
                 raster: Optional[tuple] = None,
                 bg_ray_colors: Optional[torch.Tensor] = None,
                 verbose: bool = False) -> FastRenderOutput:
    """Full-frame render with frame-level ray packing and per-chunk
    depth-window tiers. Exact (the outputs of rendering the raw ray order
    with depth_window off) while every chunk's counters read zero.

    A frame's rays come from one camera, so about half miss the grid box
    and the rest have widely varying in-box chords:

      1. slab-test every ray on the host (frame_ray_spans);
      2. sort: box-hitting rays first, ascending in-box span; miss rays
         render exact background and never enter the pipeline;
      3. render ceil(n_hit / chunk) dense chunks, each at the smallest
         depth-window tier (multiples of `tier_quant`) covering its
         largest span + slack; the last chunk is padded with copies of
         the last ordered rays (identical outputs land on identical
         targets). Under a march config the tier changes nothing;
      4. re-render any chunk whose cb_overflow tripped at a doubled
         compaction budget, up to the per-ray column cap, where M cannot
         overflow: a frame render never drops samples to the M cap;
      5. scatter per-ray outputs back through the sort permutation.

    `raster` = (H, W, focal or (fx, fy, cx, cy)) with a march config and
    a pinhole pixel-grid frame in row-major order: one raster program
    (ops/raster.py) bins every chunk's packed emit rows up front and the
    per-chunk walk is skipped. Where the raster does not serve the frame
    (`RasterUnserved`: the reference's own ValueError / RuntimeError
    conditions, a non-zero raster counter) the frame is walked instead;
    any other exception, a kernel that fails to build or launch included,
    propagates. The output's
    `front_end` says which front-end rendered the frame.

    `budget_tier` > 0 (below cfg.query.compact_budget) renders every
    chunk at that lower compaction budget first. `program_cache` (a dict
    kept across frames) holds the scene's qvox table and the raster
    programs by ladder. `host_rays`: a host copy of `raydirs`, which
    saves the device pull. `bg_ray_colors` [Rtot, 3] (the plane model's
    per-ray background) replaces cfg.bg_color ray by ray. dw_overflow,
    cb_overflow and mc_overflow are summed over chunks; rb_overflow is None
    (the packing happens here, by a conservative slab test that cannot drop
    a hitting ray). On a hash grid's cache the bounds are its logical dims
    and the raster is not used (it bins against the dense qslot table), as
    in the reference. Unlike the reference there is no `render_maker`:
    the port has no sharded renderer."""
    q = cfg.query
    D = q.z_depth_dim
    dev = raydirs.device
    Rtot = raydirs.shape[0]
    dims = cache_dims(cache)
    rd_np = _np(host_rays if host_rays is not None else raydirs, np.float32)
    order, n_hit, span = frame_ray_order(
        _np(campos, np.float32), rd_np, near, far, D, ranges_min, dims,
        scaled_vsize)

    pcache = program_cache if program_cache is not None else {}
    emit_tbl = None
    front_end = "march" if march_active(q) else "depth_window"
    if raster is not None and march_active(q) and cache.hash_table is None:
        try:
            emit_tbl, _ = frame_raster_emit(
                cache, campos, camrotc2w, raydirs, near, far, q, ranges_min,
                scaled_vsize, raster, pcache)
            front_end = "raster"
        except RasterUnserved as e:
            if verbose:
                print(f"render_frame: raster disabled ({e}); walking this "
                      f"frame", file=sys.stderr)

    f32 = torch.float32
    if bg_ray_colors is not None:
        color = bg_ray_colors.to(device=dev, dtype=f32).clone()
    else:
        color = torch.as_tensor(cfg.bg_color, dtype=f32,
                                device=dev).expand(Rtot, 3).contiguous()
    ray_mask = torch.zeros(Rtot, dtype=torch.bool, device=dev)
    acc = torch.zeros(Rtot, dtype=f32, device=dev)
    depth = torch.zeros(Rtot, dtype=f32, device=dev)
    sums = {"dw_overflow": None, "cb_overflow": None, "mc_overflow": None}

    n_chunks = (n_hit + chunk - 1) // chunk
    if n_chunks:
        n_used = n_chunks * chunk
        if n_used > Rtot:
            order = np.concatenate([order, order[Rtot - (n_used - Rtot):]])
        perm = torch.as_tensor(order[:n_used], device=dev)
        rays_p = raydirs[perm]
        bg_p = None if bg_ray_colors is None else color[perm]
        span_sorted = span[order[:n_used]]

        def render(i, dw, b):
            sl = slice(i * chunk, (i + 1) * chunk)
            cfg_t = dataclasses.replace(cfg, query=dataclasses.replace(
                q, depth_window=dw, ray_budget=0, compact_budget=b))
            return fast_render_rays(
                params, Rw2c, cache, campos, camrotc2w, rays_p[sl], near,
                far, cfg_t, ranges_min, scaled_vsize,
                premarch=None if emit_tbl is None else (emit_tbl, perm[sl]),
                bg_ray_colors=None if bg_p is None else bg_p[sl])

        b_full = q.compact_budget if q.compact_budget > 0 else q.SR
        b_cap = min(q.SR, q.ray_slot_budget or min(q.SR, 32))
        b_now = budget_tier if 0 < budget_tier < b_full else b_full
        results, dws = [], []
        for i in range(n_chunks):
            smax = int(span_sorted[i * chunk:(i + 1) * chunk].max())
            tier = min(D, -(-(smax + dw_slack) // tier_quant) * tier_quant)
            dws.append(tier if tier < D else 0)
            results.append(render(i, dws[i], b_now))
        # budget escalation: one deferred device sync per level, usually
        # none or one
        while b_now < b_cap:
            trip = [i for i, r in enumerate(results)
                    if r.cb_overflow is not None and int(r.cb_overflow) > 0]
            if not trip:
                break
            b_now = min(max(2 * b_now, b_full), b_cap)
            for i in trip:
                results[i] = render(i, dws[i], b_now)
        for i, res in enumerate(results):
            ids = perm[i * chunk:(i + 1) * chunk]
            color[ids] = res.coarse_raycolor
            ray_mask[ids] = res.ray_mask
            acc[ids] = res.acc.to(f32)
            depth[ids] = res.depth.to(f32)
            for f in sums:
                v = getattr(res, f)
                if v is not None:
                    sums[f] = v if sums[f] is None else sums[f] + v

    return FastRenderOutput(
        coarse_raycolor=color, ray_mask=ray_mask, acc=acc, depth=depth,
        rb_overflow=None, front_end=front_end, **sums)
