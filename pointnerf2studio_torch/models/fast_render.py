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
(win_overflow, dw_overflow, rb_overflow, cb_overflow, pb_overflow) and
n_valid_slots. The chunk decode, `chunk_pipeline` (the reference's, with
its arguments: perf probes time it on compaction outputs handed in), is
one of

  knn_mode="xla", chunk_mode="xla" (the reference's default): the XLA
  candidate stages as torch ops, in chunks of CH slots (`_xla_route`;
  `_xla_front`: the fat-row gather, candidate d2,
  the radius / valid / layered-shell masks, the exact K smallest by a
  stable sort; `_xla_extract`: the payload extract), then `_decode_tail`
  or, under decode_mode="pair", `_pair_tail`; the only route that gives
  the prob outputs;
  chunk_mode="fused" with an eligible aggregator and fused_decode2 off:
  the whole chunk in one kernel (ops/fused_chunk.py);
  knn_mode="fused", or chunk_mode="fused" otherwise (the staged path):
  the candidate selection kernel (ops/fused_select.py), the decode tail
  in torch (`_decode_tail`), and the tower either as the K-accumulating
  decode kernel (ops/fused_decode.py, AggregatorConfig.fused_decode2
  with an eligible config) or as `decode_radiance`.

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

The reference's opt-in routes are here too: chunk_mode="fused" where
the whole fused chunk does not apply (the selection kernel, then the
decode tail, as the reference degrades), and on the XLA route the
two-phase pipeline (`decode_chunk2`), the valid-pair decode
(decode_mode="pair", `pb_overflow`), the slim selection view
(extract_mode="krows"), the per-point layer-1 table (`base_cache`) and
the pruned candidate width (`cand_prune`); in the front-end the span
tiers (`span_tiers`), the two-level coarse test (`coarse_step`,
`win_overflow`) and the one-hot compaction; the slot-grid composite
(composite_mode="grid"); `render_frame`'s `render_maker`; and the perf
probes (`debug_ablate`, PROBES) and `chunk_pipeline`'s `skip_policy`. With
`pshard_axis` the cache's candidate rows are one rank's qslot slab of a
cache sharded over a mesh axis (parallel/sharding.py): the XLA route
computes the slots the slab owns and a psum reassembles them.

Host synchronisation: none per chunk on the kernel routes (ray packing
and slot packing are cumsum/scatter compactions on the device, and the
kernels skip masked slots themselves); the XLA route reads its live
chunks back once per call, to skip its all-padding chunks as the
reference's `chunk_or_skip` does.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import (
    Aggregator, aggregation_weight, decode_radiance, decode_radiance_pairs,
    pair_decode_eligible, precompute_base_h, raw_aggregation_weight)
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.ops.camera import neighbor_dists, rotate, w2pers
from pointnerf2studio_torch.ops.compositing import (
    TONE_MAPS, composite_rows, packed_alpha_composite,
    segment_sums_contiguous)
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
    candidate_keep_mask, layered_k_nearest, neighbor_offsets, shell_eligible)
from pointnerf2studio_torch.ops.raster import (
    RasterUnserved, _voxel_footprint, build_qvox, make_raster_program)
from pointnerf2studio_torch.ops.select import (
    rank_gather_pack, select_first_cols)
from pointnerf2studio_torch.utils import profiling

PAYW = 44                 # bf16 payload per candidate: xyz_rel(3) +
                          # emb(32) + conf(1) + dir(3) + color(3) + pad(2)
ROWW = 1 + PAYW // 2      # f32 words per candidate in the reference's
                          # "rows" layout (its cache sizing counts them)
TAIL_CHUNK = 1 << 16      # slots per piece of the decode_radiance tail
# the perf probes (`debug_ablate`) of fast_render_rays' front-end, and of
# chunk_pipeline: one stage faked, or the chunk cut short after a stage
# (the "p_" keys, cumulative prefixes of the chunk body)
FRONT_PROBES = ("qslot", "compact", "selonly", "scatterback")
CHUNK_PROBES = ("gather", "knn", "extract", "weights", "decode",
                "p_gather", "p_geom", "p_knn", "p_extract", "p_dists")
PROBES = FRONT_PROBES + CHUNK_PROBES


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
    config routes the front-end through the march. `make_fast_scene` adds
    the config's other tables: `coarse_occ` (coarse_step), `base_h`
    (base_cache) and `slim` (extract_mode="krows", words of kmeta and
    kcand, no copy of the payload).
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
    # occupancy dilated for the two-level sample test (coarse_step)
    coarse_occ: Optional[torch.Tensor] = None      # [gx, gy, gz] bool
    # per-point mlp_base layer-1 partial product (base_cache)
    base_h: Optional[torch.Tensor] = None          # [N, hidden] bf16
    # the selection words of extract_mode="krows": per candidate the
    # meta word and bf16 (x, y), (z, emb0) pairs, as float32 words
    slim: Optional[torch.Tensor] = None            # [max_q, C * 3] f32

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
                    cand_cap: int = 64, chunk: int = 32768,
                    coarse_dilate: int = 0, cand_prune: bool = False,
                    radius2: float = 0.0, knn_k: int = 8) -> FatCache:
    """Build the candidate cache (see `FatCache`) of a PointGrid or a
    HashGrid, once per point/attribute change. Candidates in the order of
    `ordered_candidates`. `cand_prune` keeps the candidates that
    `ops/query.candidate_keep_mask` keeps, judged on the bf16 relative
    xyz the render's d2 reads, at the front of each row in their order,
    and marks the rest empty (make_fast_scene then cuts the width).
    `coarse_dilate` L > 0 adds `coarse_occ`: the occupancy dilated by a
    (2L + 1)^3 max (a dense grid only)."""
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
    half = grid.scaled_vsize * 0.5
    max_shell = (kernel_size[0] + 1) // 2 - 1
    iota = torch.arange(C, device=dev)
    for sl, (sel_ok, sel_pidx, sel_sh, sel_xyz) in candidate_pieces(
            grid, cloud.xyz, kernel_size, C, q_coor, center_w, q_live, chunk):
        cw = center_w[sl][:sel_ok.shape[0]]
        B = cw.shape[0]
        rel = (sel_xyz - cw[:, None, :]).to(torch.bfloat16)     # [B, C, 3]
        if cand_prune:
            keep = candidate_keep_mask(rel.float(), sel_sh, sel_ok, half,
                                       radius2, knn_k, max_shell)
            pos = torch.sort(torch.where(keep, iota, C + 1), dim=-1,
                             stable=True).indices
            sel_ok = torch.gather(keep, 1, pos)
            sel_pidx = torch.gather(sel_pidx, 1, pos)
            sel_sh = torch.gather(sel_sh, 1, pos)
            rel = torch.gather(rel, 1, pos[..., None].expand(B, C, 3))
        kmeta[sl] = torch.where(sel_ok, sel_pidx * 4 + sel_sh,
                                -1).to(torch.int32)
        sel_attr = attrs[torch.clamp(sel_pidx, 0, N - 1)]       # [B, C, 39]
        kcand[sl] = torch.cat([rel, sel_attr, rel.new_zeros((B, C, PK - 42))],
                              -1)
        kxyz[sl] = rel.transpose(1, 2)
    hashed = isinstance(grid, HashGrid)
    coarse_occ = (coarse_occupancy(grid.coor_occ, coarse_dilate)
                  if coarse_dilate > 0 else None)
    return FatCache(coor_2_qslot=coor_2_qslot, kmeta=kmeta, kcand=kcand,
                    kxyz=kxyz, n_q=n_q,
                    hash_table=grid.table if hashed else None,
                    logical_dims=grid.dims if hashed else None,
                    coarse_occ=coarse_occ)


def coarse_dilation(q, near: float, far: float) -> int:
    """L, the dilation of the coarse occupancy under q.coarse_step: a
    window of coarse_step samples spaced (far - near) / z_depth_dim
    reaches (coarse_step - 1) / 2 samples from its centre, in voxels."""
    dt = (far - near) / q.z_depth_dim
    return math.ceil((q.coarse_step - 1) / 2 * dt / min(q.scaled_vsize))


def coarse_occupancy(coor_occ: torch.Tensor, L: int) -> torch.Tensor:
    """The occupancy [gx, gy, gz] bool dilated by a (2L + 1)^3 max
    (max_pool3d: deterministic), the coarse test's table."""
    return F.max_pool3d(coor_occ.to(torch.float32)[None, None], 2 * L + 1,
                        stride=1, padding=L)[0, 0] > 0


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
                    grid: PointGrid, max_q: Optional[int] = None,
                    near: Optional[float] = None, far: Optional[float] = None,
                    params: Optional[Aggregator] = None):
    """Build the fat cache for a scene; returns (cache, ranges_min,
    scaled_vsize). max_q defaults to the query-voxel count rounded up
    to a multiple of 32768.

    The config adds to the cache what its routes read, as the reference's
    make_fast_scene does: the march table (march_steps); under
    `coarse_step` the coarse occupancy, dilated for any render whose
    sample spacing is at most (far - near) / z_depth_dim (`near`/`far`
    default to cfg.near_plane / far_plane); under `cand_prune` on the XLA
    route the pruned candidates, the stored width cut to the largest kept
    count rounded up to 8 (a line says so); under `base_cache` the
    per-point layer-1 table, which needs the aggregator `params`; under
    extract_mode="krows" the slim selection view."""
    q = cfg.query
    xla_layout = "fused" not in (q.knn_mode, q.chunk_mode)
    if q.extract_mode == "krows" and not xla_layout:
        raise ValueError("extract_mode='krows' needs the 'rows' cache "
                         "layout (knn_mode/chunk_mode 'xla')")
    if q.base_cache:
        _check_base_cache(cfg, params)
    if max_q is None:
        nq = int(grid.coor_occ.sum())
        max_q = (nq + 32767) // 32768 * 32768
    coarse_dilate = 0
    if q.coarse_step > 1:
        coarse_dilate = coarse_dilation(
            q, near if near is not None else cfg.near_plane,
            far if far is not None else cfg.far_plane)
    prune = q.cand_prune and xla_layout
    cc = fit_cand_cap(max_q, q.cand_cap, device=cloud.xyz.device)
    cache = build_fat_cache(grid, cloud, q.kernel_size, max_q, cc,
                            coarse_dilate=coarse_dilate, cand_prune=prune,
                            radius2=float(q.radius_limit) ** 2, knn_k=q.K)
    if prune:
        C = cache.cand
        kept = int((cache.kmeta >= 0).sum(-1).max())
        c2 = min(C, max(8, -(-kept // 8) * 8))
        if c2 < C:
            cache.kmeta = cache.kmeta[:, :c2].contiguous()
            cache.kcand = cache.kcand[:, :c2].contiguous()
            cache.kxyz = cache.kxyz[:, :, :c2].contiguous()
        print(f"cand_prune: width {C} -> {c2} (max kept {kept})")
    if march_active(q):
        cache.march_table = build_march_table(cache.coor_2_qslot)
    _add_route_tables(cache, cfg, cloud, params)
    return cache, grid.ranges_min, grid.scaled_vsize


def _check_base_cache(cfg: PointNerfConfig, params) -> None:
    """The reference's refusals of QueryConfig.base_cache."""
    if params is None:
        raise ValueError(
            "QueryConfig.base_cache needs the aggregator params at scene "
            "build: make_fast_scene(..., params=params)")
    if cfg.agg.agg_intrp_order < 1:
        raise ValueError("base_cache requires agg_intrp_order >= 1 (order 0 "
                         "encodes the K-aggregated embedding)")
    if cfg.agg.fused_decode2:
        raise ValueError("base_cache is incompatible with fused_decode2")
    if "fused" in (cfg.query.knn_mode, cfg.query.chunk_mode):
        raise ValueError("base_cache requires knn_mode/chunk_mode 'xla'")


def build_slim(cache: FatCache) -> torch.Tensor:
    """The selection view of extract_mode="krows", [max_q, C * 3] float32
    words: per candidate the meta word (kmeta's bits), then the bf16
    pairs (x, y) and (z, emb0) of kcand, the reference's rows[..., :3]
    word for word."""
    words = torch.cat([cache.kmeta[..., None],
                       cache.kcand[..., :4].contiguous().view(torch.int32)],
                      -1)                                       # [max_q, C, 3]
    return words.view(torch.float32).reshape(cache.max_q, -1)


def _add_route_tables(cache: FatCache, cfg: PointNerfConfig,
                      cloud: NeuralPointCloud, params) -> None:
    q = cfg.query
    if q.base_cache:
        _check_base_cache(cfg, params)
        cache.base_h = precompute_base_h(params, cfg.agg,
                                         cloud.points_embeding)
    if q.extract_mode == "krows":
        cache.slim = build_slim(cache)


def make_hash_fast_scene(cfg: PointNerfConfig, cloud: NeuralPointCloud,
                         hg: HashGrid, max_q: Optional[int] = None,
                         params: Optional[Aggregator] = None):
    """Build the fat cache over a sparse HashGrid; returns (cache,
    ranges_min, scaled_vsize), as make_fast_scene does for a dense grid.
    max_q defaults to n_q rounded up to a multiple of 32768. As in the
    reference, `coarse_step` and knn_mode="fused" are dense-only (the
    fused chunk, which reads no hash cache in the reference either, is
    refused by fast_render_rays), there is no march table, and
    `cand_prune` does not apply (the reference's hash cache keeps every
    candidate); `base_cache` (with `params`) and the krows view are
    built as on a dense grid."""
    q = cfg.query
    if q.coarse_step > 1:
        raise NotImplementedError(
            "coarse_step needs a dense coarse-occupancy grid; off in hash "
            "mode")
    if q.knn_mode == "fused":
        raise NotImplementedError("knn_mode='fused' is dense-only")
    if q.base_cache:
        _check_base_cache(cfg, params)
    if max_q is None:
        nq = int(hg.n_q)
        max_q = (nq + 32767) // 32768 * 32768
    cc = fit_cand_cap(max_q, q.cand_cap, device=cloud.xyz.device,
                      what="hash fat cache")
    cache = build_fat_cache_hash(hg, cloud, q.kernel_size, max_q, cc)
    _add_route_tables(cache, cfg, cloud, params)
    return cache, hg.ranges_min, hg.scaled_vsize


def onehot_select_qd(keep: torch.Tensor, rank: torch.Tensor,
                     qs: torch.Tensor, d_true: torch.Tensor, BP: int):
    """The one-hot slot compaction of compact_mode="onehot": each ray's
    kept (qslot, d) pairs (keep [R, Dax], 1-based rank along the ray)
    moved to slots rank - 1 of [R, BP]; empty slots 0 (qslot clamped at
    0, as the reference's max(qs, 0)). The reference extracts base-128
    digits through a bf16 one-hot matmul (exact for qslot < 2^21); here
    it is an integer scatter whose targets never collide, exact for
    every id on every device."""
    R, Dax = keep.shape
    dev = keep.device
    row = torch.arange(R, device=dev)[:, None] * BP
    dest = torch.where(keep, row + rank.long() - 1, R * BP).reshape(-1)

    def put(x):
        out = torch.zeros(R * BP + 1, dtype=torch.int32, device=dev)
        out[dest] = x.reshape(-1).to(torch.int32)
        return out[:R * BP].reshape(R, BP)

    return put(torch.clamp(qs, min=0)), put(d_true.expand(R, Dax))


def onehot_compact(qs: torch.Tensor, d_true: torch.Tensor, cap: int,
                   BP: int, M: int):
    """compact_mode="onehot": each ray's first `cap` valid samples (qs
    [R, Dax] >= 0, d_true [R, Dax] their sample indices) to its BP slots
    (`onehot_select_qd`), then the slots of all rays to M in ray order
    (targets that never collide; slots past M drop). Returns (sel_ray,
    sel_slot, sel_d, qslot_c [M] int64, mask_c [M] bool, cnt [R] int64)."""
    R = qs.shape[0]
    dev = qs.device
    mask = qs >= 0
    rank = torch.cumsum(mask.to(torch.int32), -1)
    keep = mask & (rank <= cap)
    q_sel, d_sel = onehot_select_qd(keep, rank, qs, d_true, BP)
    cnt = keep.sum(-1)
    off = torch.cumsum(cnt, 0) - cnt
    sloti = torch.arange(BP, device=dev).expand(R, BP)
    dest = torch.clamp(torch.where(sloti < cnt[:, None],
                                   off[:, None] + sloti, M), max=M)
    dest = dest.reshape(-1)

    def put(x):
        out = torch.zeros(M + 1, dtype=torch.long, device=dev)
        out[dest] = x.reshape(-1).long()
        return out[:M]

    mask_c = torch.arange(M, device=dev) < torch.clamp(cnt.sum(), max=M)
    return (put(torch.arange(R, device=dev)[:, None].expand(R, BP)),
            put(sloti), put(d_sel), put(q_sel), mask_c, cnt)


@dataclasses.dataclass
class FastRenderOutput:
    coarse_raycolor: torch.Tensor          # [R, 3]
    ray_mask: torch.Tensor                 # [R] bool
    acc: torch.Tensor                      # [R]
    depth: torch.Tensor                    # [R]
    # coarse_step only: true positive windows dropped by
    # coarse_win_budget (non-zero: samples were lost; None when the
    # coarse test is off)
    win_overflow: Optional[torch.Tensor] = None
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
    # decode_mode="pair" only: valid (slot, K) pairs dropped because a
    # chunk held more than CH * pair_budget of them (None when the budget
    # cannot overflow, pair_budget >= K, or pair mode is off)
    pb_overflow: Optional[torch.Tensor] = None
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
    elif q.coarse_step > 1:
        S = q.coarse_step
        DS = -(-D // S)
        BW = min(q.coarse_win_budget, DS)
        if q.depth_window > 0:
            BW = min(BW, min(DS, q.depth_window // S + 1))
        Dax = BW * S
    elif q.depth_window > 0:
        Dax = min(q.depth_window, D)
    else:
        Dax = D
    return min(budget, D) < min(SR, BP, Dax)


def has_pb_overflow(q) -> bool:
    """Whether fast_render_rays emits a pb_overflow counter for this
    query config: decode_mode="pair" with a pair budget below K."""
    if q.decode_mode != "pair":
        return False
    return (q.pair_budget if q.pair_budget > 0 else q.K) < q.K


def _use_fused2(cfg: PointNerfConfig) -> bool:
    """The K-accumulating decode kernel runs where the config asks for
    it and the tower is one its gate takes (the reference also wants a
    TPU backend: the port treats the card as that backend, and the CPU
    takes the kernel's plain version); an eligible tower outside the
    kernels' envelope raises NotImplementedError on either device."""
    return cfg.agg.fused_decode2 and fused_decode_served(
        cfg.agg, False, cfg.query.K)


def _check_served(cfg: PointNerfConfig, Rw2c: torch.Tensor,
                  prob: bool, debug_ablate=None) -> str:
    """The chunk route of a config: "chunk" (the fused chunk kernel),
    "staged" (the selection kernel, then the decode tail: knn_mode
    "fused", or chunk_mode "fused" where the whole fused chunk does not
    apply, as the reference's chunk_pipeline degrades) or "xla" (the XLA
    candidate stages, then the lane or the pair decode). A perf probe
    (`debug_ablate`) takes the XLA candidate stages and the lane decode
    whatever the config asks for, as in the reference; fused_decode2
    stays. Raises where the reference refuses the combination."""
    if debug_ablate is not None and debug_ablate not in PROBES:
        raise ValueError(f"unknown debug_ablate {debug_ablate!r}; the probes "
                         f"are {PROBES}")
    q = cfg.query
    if Rw2c.ndim != 2:
        raise NotImplementedError(
            "fast_render_rays takes a global Rw2c [3, 3]; an edited "
            "scene's per-point rotations render through "
            "models/render.render_rays (the reference's fast path has no "
            "per-point rotation either)")
    if q.decode_mode not in ("lanes", "pair"):
        raise ValueError(f"unknown decode_mode {q.decode_mode!r}")
    if q.extract_mode not in ("onehot", "gather", "krows"):
        raise ValueError(f"unknown extract_mode {q.extract_mode!r}")
    if prob and q.span_tiers:
        raise ValueError("prob mode + span_tiers not supported (growth "
                         "probes render plain chunks)")
    if debug_ablate is not None:
        if prob:
            raise ValueError(
                "prob-mode neighbour averages (want_attrs) need the default "
                "XLA one-hot decode path, which a perf probe (debug_ablate) "
                "replaces")
        return "xla"
    fused2 = _use_fused2(cfg)
    whole = (q.chunk_mode == "fused" and not fused2
             and fused_chunk_eligible(cfg.agg, False, q.K))
    staged = not whole and "fused" in (q.knn_mode, q.chunk_mode)
    if q.decode_mode == "pair":
        if whole or staged or fused2:
            raise ValueError(
                "decode_mode='pair' requires knn_mode/chunk_mode 'xla' and "
                "fused_decode2 off")
        if not pair_decode_eligible(cfg.agg, False):
            raise ValueError(
                "decode_mode='pair' requires agg_intrp_order >= 1 and a "
                "global Rw2c (per-point editing rotations decode on the "
                "lane layout)")
    if prob and (whole or staged or q.decode_mode == "pair"
                 or q.extract_mode == "krows"):
        raise ValueError(
            "prob-mode neighbour averages need the XLA route (knn_mode and "
            "chunk_mode 'xla', decode_mode 'lanes', extract_mode 'onehot' "
            "or 'gather')")
    return "chunk" if whole else "staged" if staged else "xla"


def _sum32(x: torch.Tensor, dims) -> torch.Tensor:
    """A probe's reduction of `x` over `dims` as float32, summed in float64:
    the same value on the CPU and the card, whatever order each sums in."""
    return x.sum(dims, dtype=torch.float64).float()


def _decode_tail(params: Aggregator, cfg: PointNerfConfig, Rw2c, camrotc2w,
                 campos, nsel, pnt_mask, locs, center, rd_sel,
                 want_attrs: bool = False, base_h=None, debug_ablate=None):
    """(sigma [M], rgb [M, 3], found [M]) from the selected payloads
    nsel [M, K, >= 42] bf16: neighbour geometry, aggregation weights,
    then the tower (the reference's `_decode_tail`). `want_attrs` adds
    the [M, 39] weight * conf neighbour averages of the prob outputs
    (colour 3, dir 3, conf 1, embedding 32), with the wc = weight * conf
    * pnt_mask of the legacy prob path. `base_h` [M, K, hidden]: the
    cached layer-1 rows of the selected points (base_cache). The perf
    probes of this stage: "p_dists" ends the chunk after the neighbour
    geometry, "weights" puts 0.1 in place of each aggregation weight,
    "decode" a sum of the weights and the mean neighbour colour in place
    of the tower (wrong values, the rest's real time)."""
    f32 = torch.float32
    nxyz = nsel[..., :3].to(f32) + center[:, None, :]           # [M, K, 3]
    # attribute slices stay bf16 end to end, as in the reference
    emb = nsel[..., 3:35]
    conf = nsel[..., 35].to(f32)
    ndir = nsel[..., 36:39]
    ncol = nsel[..., 39:42]
    dists = neighbor_dists(nxyz, locs, camrotc2w, campos)
    if debug_ablate == "p_dists":
        return (_sum32(dists, (-1, -2)) + _sum32(conf, -1),
                _sum32(emb, (-1, -2))[:, None] + ncol.to(f32).mean(-2)
                + ndir.to(f32).mean(-2), pnt_mask.any(-1))
    if debug_ablate == "weights":
        weight, emb2 = pnt_mask.to(f32) * 0.1, emb
    else:
        weight, emb2 = aggregation_weight(cfg.agg, emb, dists, pnt_mask,
                                          max(cfg.query.scaled_vsize), params)
        if cfg.agg.conf_in_weight:
            weight = weight * conf
    vd = rotate(rd_sel, Rw2c)
    if debug_ablate == "decode":
        # the mean of bf16 values is a bf16 value, as in the reference
        sig = (weight * pnt_mask).sum(-1) * 100.0
        rgb = (ncol.to(f32).sum(-2) / ncol.shape[-2]).to(ncol.dtype).to(f32)
    elif _use_fused2(cfg):
        dists_rot, dirdot, wk, dir_pe = tower_inputs(
            cfg.agg, dists, ndir, vd, weight, pnt_mask, Rw2c)
        sig, rgb = fused_decode2(
            params, emb2, dists_rot, ncol, dirdot, wk, dir_pe,
            cfg.agg.num_feat_freqs, cfg.agg.num_dist_freqs)
    else:
        sig, rgb = decode_radiance(
            params, cfg.agg, neigh_emb=emb2, neigh_color=ncol,
            neigh_dir=ndir, dists=dists, weight=weight, pnt_mask=pnt_mask,
            viewdirs=vd, Rw2c=Rw2c, base_h=base_h)
    if not want_attrs:
        return sig, rgb, pnt_mask.any(-1)
    wc = (weight * conf * pnt_mask.to(weight.dtype))[..., None].to(f32)
    attrs = torch.cat([(ncol.to(f32) * wc).sum(-2),
                       (ndir.to(f32) * wc).sum(-2),
                       (conf[..., None] * wc).sum(-2),
                       (emb.to(f32) * wc).sum(-2)], -1)
    return sig, rgb, pnt_mask.any(-1), attrs


def _xla_front(cfg: PointNerfConfig, cache: FatCache, qslot, locs, center,
               mask, num_shells: int, debug_ablate=None):
    """The candidate stages of the reference's XLA chunk body on Mc slots:
    the row gather by qslot [Mc], candidate d2 from the bf16 relative xyz
    plus `center - locs`, the valid / radius masks and the layered K
    smallest d2 (`layered_k_nearest`: valid first, smallest column on
    ties). Returns (top [Mc, K], pnt_mask [Mc, K], meta [Mc, C], payload
    [Mc, C, PK] bf16, or None under extract_mode="krows", whose
    selection reads only the slim view's three words a candidate).

    The perf probes of these stages: "gather" broadcasts row 0 in place of
    the row gather and "knn" takes the first K candidates in place of the
    selection (wrong values, the rest's real time); "p_gather", "p_geom"
    and "p_knn" end the chunk after the gather, after the masks and after
    the selection, and return the reference's cut-off (sigma [Mc], rgb
    [Mc, 3], found [Mc]) in place of the four stages' outputs."""
    q = cfg.query
    Mc = qslot.shape[0]
    K = q.K
    if q.extract_mode == "krows" and debug_ablate is None:
        if cache.slim is None:
            raise ValueError(
                "extract_mode='krows' needs the slim cache view "
                "(make_fast_scene builds it under this mode)")
        slim3 = cache.slim[qslot].reshape(Mc, cache.cand, 3)
        meta = slim3[..., 0].view(torch.int32)
        rel = slim3[..., 1:].contiguous().view(torch.bfloat16)  # [Mc, C, 4]
        payload = None
    else:
        if debug_ablate == "gather":
            meta = cache.kmeta[:1].expand(Mc, -1)
            payload = cache.kcand[:1].expand(Mc, -1, -1)
        else:
            meta = cache.kmeta[qslot]                           # [Mc, C]
            # the candidate rows move as 8-byte words (a bf16 index copy
            # moves two bytes an element)
            payload = cache.kcand.view(torch.int64).index_select(
                0, qslot).view(torch.bfloat16)                  # [Mc, C, PK]
        if debug_ablate == "p_gather":
            return (_sum32(payload[..., :PAYW], (-1, -2)),
                    _sum32(meta, -1)[:, None].expand(Mc, 3), mask)
        rel = payload
    cd = center - locs
    dx = rel[..., 0].float() + cd[:, 0:1]
    dy = rel[..., 1].float() + cd[:, 1:2]
    dz = rel[..., 2].float() + cd[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    ok = (meta >= 0) & mask[:, None]
    radius2 = q.radius_limit ** 2
    if radius2 > 0:
        ok = ok & (d2 <= radius2)
    ok = shell_eligible(ok, meta & 3, K, num_shells)
    if debug_ablate == "p_geom":
        return (_sum32(d2, -1) + _sum32(ok, -1),
                _sum32(dx + dy + dz, -1)[:, None].expand(Mc, 3), mask)
    if debug_ablate == "knn":
        top = torch.arange(K, device=qslot.device).expand(Mc, K)
        pnt_mask = ok[:, :K]
    else:
        top, pnt_mask = layered_k_nearest(d2, ok, meta & 3, K, 1)
    if debug_ablate == "p_knn":
        key = torch.where(pnt_mask, torch.gather(d2, 1, top), 0.0)
        return (_sum32(key, -1), _sum32(top, -1)[:, None].expand(Mc, 3),
                pnt_mask.any(-1))
    return top, pnt_mask, meta, payload


def _xla_extract(cache: FatCache, qslot, top, pnt_mask, payload,
                 debug_ablate=None):
    """The selected payloads nsel [Mc, K, PAYW] bf16, zero where
    pnt_mask is off: a gather from the gathered rows (equal to the
    reference's one-hot einsum: one bf16 value passes its f32 accumulator
    unchanged), or, under krows (payload None), the K chosen candidates'
    rows read straight from the cache. The probe "extract" takes the
    first K candidates' payloads, unmasked, in place of the extract."""
    Mc, K = top.shape
    if debug_ablate == "extract":
        return payload[:, :K, :PAYW]
    if payload is None:
        flat = qslot.long()[:, None] * cache.cand + top         # [Mc, K]
        nsel = cache.kcand.reshape(-1, PK)[flat][..., :PAYW]
    else:
        nsel = torch.gather(payload, 1, top[..., None].expand(Mc, K, PAYW))
    return torch.where(pnt_mask[..., None], nsel, torch.zeros_like(nsel))


def _selected_base_h(cache: FatCache, meta, top, pnt_mask):
    """base_h rows [Mc, K, hidden] of the selected points (row 0 where a
    lane is empty: its weight is zero)."""
    if cache.base_h is None:
        return None
    pidx = torch.gather(meta, 1, top) >> 2
    return cache.base_h[torch.where(pnt_mask, pidx, 0).long()]


def _pair_tail(params: Aggregator, cfg: PointNerfConfig, Rw2c, camrotc2w,
               campos, cache: FatCache, qslot, top, pnt_mask, meta, payload,
               locs, center, rd_sel, rows: int):
    """decode_mode="pair" (the reference's `_pair_tail`): the valid (slot,
    K) pairs packed into MP = rows * PB rows, rows being the chunk's
    CH slots (the reference pads its last chunk to CH), then the towers on
    the pairs and per-slot sums over each slot's run of pairs. Valid lanes
    are a K-prefix of the stable selection, so a slot's r-th pair is lane
    r; the owning slot of pair p is the count of slots whose runs end at
    or before p (a binary search on the run ends: no scatter). Returns
    (sigma, rgb, found, pb_overflow): the valid pairs past MP, dropped."""
    q = cfg.query
    Mc, K = pnt_mask.shape
    C = cache.cand
    dev = pnt_mask.device
    PB = min(q.pair_budget if q.pair_budget > 0 else K, K)
    MP = rows * PB
    cntk = pnt_mask.sum(-1)                                     # [Mc]
    off_end = torch.cumsum(cntk, 0)
    off = off_end - cntk
    total = off_end[-1]
    pim = torch.arange(MP, device=dev)
    seg = torch.clamp(torch.searchsorted(off_end, pim, right=True),
                      max=Mc - 1)                               # [MP]
    rank = pim - off[seg]
    pvalid = pim < torch.clamp(total, max=MP)
    pb = (torch.clamp(total - MP, min=0) if PB < K
          else torch.zeros((), dtype=torch.long, device=dev)).to(torch.int32)
    cand_p = top.reshape(-1)[seg * K + torch.clamp(rank, 0, K - 1)]
    if payload is None:                                         # krows
        flat = qslot.long()[seg] * C + cand_p
        pay = cache.kcand.reshape(-1, PK)[flat][:, :PAYW]
        meta_p = cache.kmeta.reshape(-1)[flat]
    else:
        flat = seg * C + cand_p
        pay = payload.reshape(Mc * C, PK)[flat][:, :PAYW]
        meta_p = meta.reshape(-1)[flat]
    pay = torch.where(pvalid[:, None], pay, torch.zeros_like(pay))
    locs_p = locs[seg]
    nxyz = pay[:, :3].float() + center[seg]
    emb = pay[:, 3:35]
    conf = pay[:, 35].float()
    ndir = pay[:, 36:39]
    ncol = pay[:, 39:42]
    dists = neighbor_dists(nxyz[:, None, :], locs_p, camrotc2w,
                           campos)[:, 0]                        # [MP, 6]
    w_raw, emb2, norm_kind = raw_aggregation_weight(
        cfg.agg, emb, dists, pvalid, max(q.scaled_vsize), params)
    seg_cnt = (torch.clamp(off_end, max=MP) - torch.clamp(off, max=MP))

    def seg_sum(x):
        return segment_sums_contiguous(x, off, seg_cnt, K)

    if norm_kind == "norm":
        weight = w_raw / torch.clamp(seg_sum(w_raw)[seg], min=1e-8)
    elif norm_kind == "count":
        weight = w_raw / torch.clamp(
            seg_sum(pvalid.to(w_raw.dtype))[seg], min=1.0)
    else:
        weight = w_raw
    if cfg.agg.conf_in_weight:
        weight = weight * conf
    base_h = None
    if cache.base_h is not None:
        base_h = cache.base_h[torch.where(pvalid, meta_p >> 2, 0).long()]
    sig, rgb = decode_radiance_pairs(
        params, cfg.agg, emb2, ncol, ndir, dists, weight, pvalid, seg_sum,
        seg, rotate(rd_sel, Rw2c), Rw2c, base_h=base_h)
    return sig, rgb, cntk > 0, pb


def _xla_route(params: Aggregator, cfg: PointNerfConfig, Rw2c, camrotc2w,
               campos, cache: FatCache, qslot_c, locs, center, rd_sel,
               mask_c, num_shells: int, want_attrs: bool, debug_ablate=None,
               skip_policy: str = "prefix"):
    """The reference's XLA chunk pipeline over the M packed slots, CH
    slots a chunk (`xla_chunk_slots`). A chunk is skipped by
    `skip_policy`: "prefix", where its first slot is invalid (the packed
    slots are a valid prefix), or "any", where it holds no valid slot (a
    point-sharded cache's ownership mask has holes); one read-back of the
    live chunks. A chunk runs the candidate stages (`_xla_front`), then
    the lane decode (`_xla_extract`, `_decode_tail`) or the pair decode
    (`_pair_tail`). With `decode_chunk2` > 0 (and no pair, krows, prob,
    base_h, fused_decode2 or probe, and M > CH, the reference's gate) the
    pipeline runs in two phases: the candidate stages chunk by chunk into
    a materialised [M, K] selection, then the tower in pieces of
    decode_chunk2 slots, each skipped by the same policy. Returns (sig
    [M], rgb [M, 3], found [M], pb_overflow [] int32, attrs [M, 39] or
    None)."""
    q = cfg.query
    K = q.K
    M = qslot_c.shape[0]
    dev = qslot_c.device
    f32 = torch.float32
    CH = xla_chunk_slots(q, M)

    def starts(step):
        n = -(-M // step)
        pieces = F.pad(mask_c, (0, n * step - M)).view(n, step)
        live = pieces[:, 0] if skip_policy == "prefix" else pieces.any(1)
        return (torch.nonzero(live)[:, 0] * step).tolist()

    sig = torch.zeros(M, dtype=f32, device=dev)
    rgb = torch.zeros((M, 3), dtype=f32, device=dev)
    found = torch.zeros(M, dtype=torch.bool, device=dev)
    attrs_m = (torch.zeros((M, PAYW - 5), dtype=f32, device=dev)
               if want_attrs else None)
    pair = q.decode_mode == "pair" and debug_ablate is None
    pb = torch.zeros((), dtype=torch.int32, device=dev)
    two_phase = (q.decode_chunk2 > 0 and debug_ablate is None and not pair
                 and not _use_fused2(cfg) and q.extract_mode != "krows"
                 and not want_attrs and cache.base_h is None and M > CH)
    if two_phase:
        nsel_m = torch.zeros((M, K, PAYW), dtype=torch.bfloat16, device=dev)
        pm_m = torch.zeros((M, K), dtype=torch.bool, device=dev)
        for s in starts(CH):
            c = slice(s, s + CH)
            top, pm, _, payload = _xla_front(cfg, cache, qslot_c[c], locs[c],
                                             center[c], mask_c[c], num_shells)
            nsel_m[c] = _xla_extract(cache, qslot_c[c], top, pm, payload)
            pm_m[c] = pm
        DC2 = max(min(q.decode_chunk2, -(-M // CH) * CH), 1)
        for s in starts(DC2):
            c = slice(s, s + DC2)
            sig[c], rgb[c], found[c] = _decode_tail(
                params, cfg, Rw2c, camrotc2w, campos, nsel_m[c], pm_m[c],
                locs[c], center[c], rd_sel[c])
        return sig, rgb, found, pb, None
    for s in starts(CH):
        c = slice(s, s + CH)
        front = _xla_front(cfg, cache, qslot_c[c], locs[c], center[c],
                           mask_c[c], num_shells, debug_ablate)
        if debug_ablate in ("p_gather", "p_geom", "p_knn"):
            sig[c], rgb[c], found[c] = front
            continue
        top, pm, meta, payload = front
        if pair:
            sig[c], rgb[c], found[c], pb_c = _pair_tail(
                params, cfg, Rw2c, camrotc2w, campos, cache, qslot_c[c], top,
                pm, meta, payload, locs[c], center[c], rd_sel[c], CH)
            pb = pb + pb_c
            continue
        nsel = _xla_extract(cache, qslot_c[c], top, pm, payload, debug_ablate)
        if debug_ablate == "p_extract":
            sig[c] = _sum32(nsel, (-1, -2))
            rgb[c] = _sum32(pm, -1)[:, None].expand(-1, 3)
            found[c] = pm.any(-1)
            continue
        res = _decode_tail(params, cfg, Rw2c, camrotc2w, campos, nsel, pm,
                           locs[c], center[c], rd_sel[c], want_attrs,
                           base_h=_selected_base_h(cache, meta, top, pm),
                           debug_ablate=debug_ablate)
        sig[c], rgb[c], found[c] = res[0], res[1], res[2]
        if want_attrs:
            attrs_m[c] = res[3]
    return sig, rgb, found, pb, attrs_m


def slot_geometry(raydirs, campos, near, step_t, sel_ray, sel_d, ranges_min,
                  scaled_vsize):
    """Per packed slot: its ray's direction rd_sel [M, 3], its sample's
    location locs [M, 3] (near + (d + 0.5) * step_t along the ray) and the
    centre [M, 3] of the voxel it lies in."""
    rd_sel = raydirs[sel_ray]
    t_sel = near + (sel_d.to(torch.float32) + 0.5) * step_t
    locs = campos + rd_sel * t_sel[:, None]
    vox = torch.floor((locs - ranges_min) / scaled_vsize)
    return rd_sel, locs, ranges_min + (vox + 0.5) * scaled_vsize


@torch.no_grad()
def chunk_pipeline(params: Aggregator, Rw2c, cache: FatCache, raydirs, campos,
                   camrotc2w, near, step_t, cfg: PointNerfConfig, ranges_min,
                   scaled_vsize, qslot_c, sel_ray, sel_d, mask_c,
                   debug_ablate: Optional[str] = None,
                   skip_policy: str = "prefix", want_attrs: bool = False):
    """The chunk decode of `fast_render_rays` over M packed slots (qslot_c
    [M], sel_ray [M], sel_d [M], mask_c [M] bool), as the reference's
    module-level `chunk_pipeline` (same arguments in the same order), so
    that perf probes can time it on real compaction outputs. `near` and
    `step_t` are the depth range's start and the sample spacing.

    Routes as `_check_served` says: the fused chunk kernel, the selection
    kernel then the decode tail, or the XLA candidate stages (`_xla_route`)
    then the lane or the pair decode. `debug_ablate` (one of CHUNK_PROBES,
    or a front-end probe of `fast_render_rays`, which passes its key on)
    takes the XLA stages with the lane decode and one stage faked or the
    chunk cut short after a stage: the outputs are wrong, the time of the
    rest is real. `skip_policy` is how an all-padding chunk is found (see
    `_xla_route`). Returns (sig [M], rgb [M, 3], found [M], pb_overflow []
    int32: the valid pairs the pair decode dropped, else 0), and the [M,
    39] neighbour averages of the prob outputs with `want_attrs`."""
    if skip_policy not in ("prefix", "any"):
        raise ValueError(f"unknown skip_policy {skip_policy!r}")
    route = _check_served(cfg, Rw2c, want_attrs, debug_ablate)
    geom = slot_geometry(raydirs, campos, near, step_t, sel_ray, sel_d,
                         ranges_min, scaled_vsize)
    return _chunk_body(params, Rw2c, cache, campos, camrotc2w, cfg, route,
                       qslot_c, mask_c, *geom, debug_ablate, skip_policy,
                       want_attrs)


def _chunk_body(params: Aggregator, Rw2c, cache: FatCache, campos,
                camrotc2w, cfg: PointNerfConfig, route: str, qslot_c, mask_c,
                rd_sel, locs, center, debug_ablate, skip_policy: str,
                want_attrs: bool):
    """`chunk_pipeline` on the route `_check_served` gave and the slots'
    `slot_geometry` (rd_sel, locs, center [M, 3]), which `fast_render_rays`
    computes once for the chunks and its packed composite."""
    q = cfg.query
    K = q.K
    M = qslot_c.shape[0]
    num_shells = (q.kernel_size[0] + 1) // 2 if q.layered_search else 1
    zero_pb = torch.zeros((), dtype=torch.int32, device=qslot_c.device)
    if route == "chunk":
        # ---- selection + tower per slot in one kernel launch
        sig, rgb, found = fused_chunk_decode(
            params, Rw2c, camrotc2w, campos, cache.kmeta, cache.kcand,
            cache.kxyz, qslot_c.to(torch.int32), locs.contiguous(),
            center.contiguous(), rd_sel.contiguous(), mask_c, K=K,
            radius2=q.radius_limit ** 2, num_shells=num_shells,
            nff=cfg.agg.num_feat_freqs, ndf=cfg.agg.num_dist_freqs,
            nvf=cfg.agg.num_viewdir_freqs, act_super=cfg.agg.act_super)
        return sig, rgb, found, zero_pb
    if route == "staged":
        # ---- staged: the select kernel, then the decode tail. Under
        # decode_radiance the tail runs in pieces of TAIL_CHUNK slots:
        # every stage is per slot, so the pieces change no result; they
        # bound the [M, K, 284] feature and its PE intermediates
        nsel, pnt_mask = fused_candidate_select(
            cache.kmeta, cache.kcand, cache.kxyz, qslot_c.to(torch.int32),
            (center - locs).contiguous(), mask_c, K, q.radius_limit ** 2,
            num_shells)
        piece = max(M, 1) if _use_fused2(cfg) else TAIL_CHUNK
        tails = [_decode_tail(params, cfg, Rw2c, camrotc2w, campos,
                              nsel[s:s + piece], pnt_mask[s:s + piece],
                              locs[s:s + piece], center[s:s + piece],
                              rd_sel[s:s + piece])
                 for s in range(0, M, piece)]
        sig, rgb, found = (torch.cat(x) for x in zip(*tails))
        return sig, rgb, found, zero_pb
    sig, rgb, found, pb, attrs = _xla_route(
        params, cfg, Rw2c, camrotc2w, campos, cache, qslot_c, locs, center,
        rd_sel, mask_c, num_shells, want_attrs, debug_ablate, skip_policy)
    return (sig, rgb, found, pb, attrs) if want_attrs else (sig, rgb, found,
                                                            pb)


def xla_chunk_slots(q, M: int) -> int:
    """CH, the slots of one chunk of the XLA route: the reference's
    max(min(fast_chunk or 8192, decode_chunk or M, M), min(2048, M))."""
    return max(min(q.fast_chunk or 8192, q.decode_chunk or M, M),
               min(2048, M))


def pack_first(flag: torch.Tensor, RB: int):
    """The first RB rows of `flag` [R] in row order: (ray_ids [RB] long,
    valid [RB] bool, overflow [] int32 = the flagged rows past RB), by a
    cumsum and a scatter whose targets never collide (no sync). Padding
    rows repeat row 0, as in the reference."""
    dev = flag.device
    R = flag.shape[0]
    pos = torch.cumsum(flag.long(), 0) - 1
    dest = torch.where(flag & (pos < RB), pos, RB)
    ray_ids = torch.zeros(RB + 1, dtype=torch.long, device=dev).scatter_(
        0, dest, torch.arange(R, device=dev))[:RB]
    n = flag.sum()
    valid = torch.arange(RB, device=dev) < n
    return ray_ids, valid, torch.clamp(n - RB, min=0).to(torch.int32)


def pack_hit_rays(cache, campos, raydirs, near, far, q, ranges_min,
                  scaled_vsize, jitter: float = 0.0):
    """Ray packing of one chunk: (ray_ids [RB] long, valid [RB] bool,
    rb_overflow [] int32) for RB = min(q.ray_budget, R). `ray_ids` holds
    the first RB box-hitting rays in ray order (`pack_first`); the
    padding rows repeat ray 0, as in the reference, and are False in
    `valid`. `jitter` (the train path's) widens the far margin by
    jitter/2 * (far - near): jittered segment lengths sum past far.
    `cache` is a FatCache or a GeoCache (its voxel bounds, `cache_dims`,
    size the box)."""
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    near = torch.as_tensor(near, dtype=f32, device=dev)
    far = torch.as_tensor(far, dtype=f32, device=dev)
    step_t = (far - near) / q.z_depth_dim
    dims_f = torch.tensor(cache_dims(cache), device=dev).to(f32)
    rmax = ranges_min + dims_f * scaled_vsize
    t_enter, t_exit = slab(raydirs, campos, ranges_min, rmax)
    far_slack = jitter * 0.5 * (far - near) + step_t if jitter else step_t
    hit = ((t_exit + step_t >= t_enter) & (t_exit >= near - step_t)
           & (t_enter <= far + far_slack))
    return pack_first(hit, min(q.ray_budget, R))


def voxel_index(cache, pos: torch.Tensor, ranges_min: torch.Tensor,
                scaled_vsize: torch.Tensor):
    """The voxel of each position [..., 3] in the grid of `cache` (a
    FatCache or a GeoCache): (gc [..., 3] int32 cell, inb [...] inside the
    grid, fi [...] the flat index of the cell clamped into the grid)."""
    dims = cache_dims(cache)
    dims_t = torch.tensor(dims, device=pos.device)
    gc = torch.floor((pos - ranges_min) / scaled_vsize).to(torch.int32)
    inb = ((gc >= 0) & (gc < dims_t)).all(-1)
    gcc = torch.minimum(torch.clamp(gc, min=0), dims_t - 1).long()
    fi = (gcc[..., 0] * dims[1] + gcc[..., 1]) * dims[2] + gcc[..., 2]
    return gc, inb, fi


def qslot_lookup(cache, pos: torch.Tensor, ranges_min: torch.Tensor,
                 scaled_vsize: torch.Tensor) -> torch.Tensor:
    """The qslot of the voxel each position [..., 3] lies in, -1 outside
    the grid or outside every query voxel: a gather from the dense qslot
    table of `cache` (a FatCache or a GeoCache), or its hash table's
    lookup (the reference's `_qs_lookup`)."""
    gc, inb, fi = voxel_index(cache, pos, ranges_min, scaled_vsize)
    if cache.hash_table is not None:
        return table_qslot(cache.hash_table, gc, inb)
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
    pshard_axis=None,               # parallel/sharding.Axis: the cache's
                                    # candidate rows are this rank's qslot
                                    # slab (sharding.shard_fat_cache)
    debug_ablate: Optional[str] = None,     # perf probes only: one of
                                    # PROBES fakes a stage or cuts the chunk
                                    # short (wrong output, real timing)
) -> FastRenderOutput:
    """Render R rays through the fast path (see the module docstring).

    The perf probes (`debug_ablate`, the reference's): "qslot" fakes the
    qslot table gather (the flat voxel index mod 97, over all D samples:
    no march, coarse test or depth window), "compact" the compaction
    (fabricated slots, some 3.4 a ray; the grid composite), "selonly" the
    column selection (a static column slice), "scatterback" the grid
    composite's scatter to [R, BP] (broadcasts of the first BP slots); the
    march is off under the first three. A chunk probe (CHUNK_PROBES) is
    passed on to `chunk_pipeline`, and any probe takes the XLA candidate
    stages there. The outputs are wrong on purpose; the time of the rest
    is real."""
    route = _check_served(cfg, Rw2c, prob, debug_ablate)
    q = cfg.query
    if pshard_axis is not None and route != "xla":
        raise ValueError(
            "a point-sharded cache renders through the XLA candidate stages "
            "only (knn_mode and chunk_mode 'xla')")
    if cache.hash_table is not None:
        # the reference's hash cache has no kernel-facing layout, and its
        # knn_mode="fused" is dense-only
        if q.chunk_mode == "fused" and debug_ablate is None:
            raise ValueError(
                "chunk_mode='fused' needs the kernel-facing cache layout, "
                "which a hash grid's cache does not serve")
        if route == "staged":
            raise NotImplementedError("knn_mode='fused' is dense-only")
    if q.base_cache and cache.base_h is None:
        raise ValueError(
            "base_cache is on but the cache has no base_h table; build it "
            "with make_fast_scene(..., params=params)")
    if isinstance(premarch, tuple):
        table, ids = premarch
        premarch = table[ids.long()]
    if premarch is not None and q.span_tiers:
        raise ValueError("premarch + span_tiers not supported")
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

    if q.span_tiers:
        return _render_span_tiers(
            params, Rw2c, cache, campos, camrotc2w, raydirs, near, far, cfg,
            ranges_min, scaled_vsize, bg_ray_colors, bg, rmax, step_t,
            pshard_axis, debug_ablate)

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
                                              else bg_ray_colors[ray_ids]),
                               pshard_axis=pshard_axis,
                               debug_ablate=debug_ablate)
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
            win_overflow=sub.win_overflow, dw_overflow=sub.dw_overflow,
            rb_overflow=rb_overflow, cb_overflow=sub.cb_overflow,
            mc_overflow=sub.mc_overflow, pb_overflow=sub.pb_overflow,
            n_valid_slots=sub.n_valid_slots, **prob_kw)

    def qs_lookup(pos):
        return qslot_lookup(cache, pos, ranges_min, scaled_vsize)

    use_march = (march_active(q)
                 and debug_ablate not in ("qslot", "compact", "selonly"))
    use_coarse = (not use_march and q.coarse_step > 1
                  and debug_ablate != "qslot")
    # under "compact" no column of qs is read: the table gather is skipped,
    # as the reference's compiled program drops it
    look = debug_ablate != "compact"
    if use_coarse and (cache.coor_2_qslot is None
                       or cache.coarse_occ is None):
        raise ValueError(
            "coarse_step needs a dense-grid cache with coarse_occ "
            "(make_fast_scene builds it when coarse_step > 1)")
    mc_overflow = dw_overflow = win_overflow = None
    if use_march:
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
    elif use_coarse:
        # ---- two-level sample masking (the reference's window-expanded
        # form): window centres of coarse_step samples tested against the
        # dilated occupancy, the first coarse_win_budget positive windows
        # of each ray kept, and only their samples looked up. Exact while
        # win_overflow == 0 (and dw_overflow == 0 under a depth window).
        qs, d_true, Dax, dw_overflow, win_overflow = _coarse_front(
            cache, q, campos, raydirs, near, far, step_t, ranges_min,
            scaled_vsize, rmax, ray_live)
    elif q.depth_window > 0 and debug_ablate != "qslot":
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
        if ray_live is not None:
            # padding rows (copies of row 0) drop: their samples are no
            # ray's (the reference counts them, ROADMAP section 3)
            hit_box = hit_box & ray_live
        dw_overflow = torch.where(
            hit_box, torch.clamp(d_hi - (d0 + DW - 1), min=0),
            0).sum().to(torch.int32)
        d_true = d0[:, None] + torch.arange(DW, device=dev, dtype=torch.int32)
        t_f = near + (d_true.to(f32) + 0.5) * step_t
        qs = (qs_lookup(campos + raydirs[:, None, :] * t_f[..., None])
              if look else None)
        Dax = DW
    else:
        t_mid = near + (torch.arange(D, device=dev, dtype=f32) + 0.5) * step_t
        pos_mid = campos + raydirs[:, None, :] * t_mid[None, :, None]
        if debug_ablate == "qslot":
            # the table gather faked: the flat voxel index mod 97
            _, inb, fi = voxel_index(cache, pos_mid, ranges_min, scaled_vsize)
            qs = torch.where(inb, fi % 97, -1)
        else:
            qs = qs_lookup(pos_mid) if look else None
        d0 = torch.zeros(R, dtype=torch.int32, device=dev)
        d_true = torch.arange(D, device=dev, dtype=torch.int32).expand(R, D)
        Dax = D
    if not use_march and ray_live is not None and look:
        # padding rows (copies of row 0) take no slots: they carry no ray,
        # so their samples would only spend the M budget (and count in
        # cb_overflow and n_valid_slots), as the march and the train path
        # give them none
        qs = torch.where(ray_live[:, None], qs, -1)
    cap_cols = R * min(SR, BP, Dax)
    pack_end = cnt_all = None
    if use_march:
        cnt_all = cnt.long().sum()
    elif debug_ablate == "compact":
        # the compaction faked: slots spread over the rays, some 3.4 valid
        # slots a ray (the reference's bench scene), so that the chunk
        # skipping and the decode work stay comparable
        Bc = max(M // R, 1)
        mi = torch.arange(M, device=dev)
        sel_ray = torch.clamp(mi // Bc, max=R - 1)
        sel_d = (mi % Bc) * (D // Bc)
        sel_slot = mi % BP
        qslot_c = (mi * 37) % torch.clamp(cache.n_q.long(), min=1)
        mask_c = mi < (R * 34) // 10
        ray_hit = torch.ones(R, dtype=torch.bool, device=dev)
    elif q.compact_mode == "topk":
        # ---- first min(SR, BP) valid columns per ray, packed to M slots
        qs = qs.to(torch.int32).contiguous()
        if debug_ablate == "selonly":
            # the column selection faked: a static slice of BP columns
            mask = qs >= 0
            ray_hit = mask.any(-1)
            col_sel = (torch.arange(BP, dtype=torch.int32, device=dev)
                       * (Dax // BP)).expand(R, BP)
            cnt = torch.clamp(mask.sum(-1), max=min(SR, BP, Dax)).to(
                torch.int32)
        else:
            col_sel, cnt, ray_hit = select_first_cols(
                qs, BP, min(SR, BP, Dax), q.select_mode)
        sel_ray, sel_slot, colm, sel, qslot_c, mask_c = rank_gather_pack(
            qs, col_sel, cnt, M)
        # the sample of each slot: column + the window's first sample
        # (the coarse windows' samples are gathered)
        sel_d = (d_true.reshape(-1)[sel].long() if use_coarse
                 else d0.long()[sel_ray] + colm)
        cnt_all = cnt.long().sum()
        pack_end = torch.cumsum(cnt.long(), 0)
    else:
        # ---- the one-hot compaction (`onehot_compact`)
        mask = qs >= 0
        ray_hit = mask.any(-1)
        sel_ray, sel_slot, sel_d, qslot_c, mask_c, cnt = onehot_compact(
            qs, d_true, min(SR, BP), BP, M)
        cnt_all = cnt.sum()
    if use_march and q.compact_mode == "topk":
        pack_end = torch.cumsum(cnt.long(), 0)
    cb_overflow = (torch.clamp(cnt_all - M, min=0).to(torch.int32)
                   if M < cap_cols and cnt_all is not None else None)

    rd_sel, locs, center = slot_geometry(raydirs, campos, near, step_t,
                                         sel_ray, sel_d, ranges_min,
                                         scaled_vsize)
    if pshard_axis is not None:
        # ---- point-sharded cache (reference :1165-1192): this rank owns
        # qslot slab [off, off + n_local) and computes only its own slots
        # (a chunk with none is skipped); each valid slot has one owner,
        # so one psum of the per-slot outputs reassembles them exactly
        from pointnerf2studio_torch.parallel.sharding import axis_index, psum
        n_local = cache.max_q
        off = axis_index(pshard_axis) * n_local
        owned = (qslot_c >= off) & (qslot_c < off + n_local)
        mask_o = mask_c & owned
        res = _chunk_body(
            params, Rw2c, cache, campos, camrotc2w, cfg, route,
            torch.where(owned, qslot_c - off, 0), mask_o, rd_sel, locs,
            center, debug_ablate, "any", prob)
        sig, rgb, found, pb = res[:4]
        attrs_m = res[4] if prob else None
        okl = (mask_o & found).to(sig.dtype)
        sig = psum(sig * okl, pshard_axis)
        rgb = psum(rgb * okl[:, None], pshard_axis)
        if prob:
            attrs_m = psum(attrs_m * okl[:, None], pshard_axis)
        found = psum(found, pshard_axis)
        if has_pb_overflow(q):
            pb = psum(pb, pshard_axis)
    else:
        res = _chunk_body(
            params, Rw2c, cache, campos, camrotc2w, cfg, route, qslot_c,
            mask_c, rd_sel, locs, center, debug_ablate, "prefix", prob)
        sig, rgb, found, pb = res[:4]
        attrs_m = res[4] if prob else None
    pb_overflow = pb if has_pb_overflow(q) else None

    slot_ok = mask_c & found
    sig = sig * slot_ok.to(sig.dtype)
    counters = dict(win_overflow=win_overflow, dw_overflow=dw_overflow,
                    cb_overflow=cb_overflow, mc_overflow=mc_overflow,
                    pb_overflow=pb_overflow,
                    n_valid_slots=mask_c.sum().to(torch.int32))
    if (prob or q.composite_mode != "packed" or q.compact_mode != "topk"
            or debug_ablate == "compact"):
        return _grid_composite(
            cfg, sig, rgb, slot_ok, attrs_m, sel_ray, sel_slot, sel_d,
            ray_hit, raydirs, campos, camrotc2w, near, step_t, BP, bg,
            counters, scatterback=debug_ablate == "scatterback")

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
        **counters)


def _coarse_front(cache: FatCache, q, campos, raydirs, near, far, step_t,
                  ranges_min, scaled_vsize, rmax, ray_live=None):
    """The coarse_step front-end (reference fast_render.py:949-1032):
    (qs [R, BW * S], d_true [R, BW * S], Dax, dw_overflow or None,
    win_overflow). Window centres are tested on the clamped cell of the
    dilated occupancy (members of a window outside the grid can still be
    inside); the first BW positive windows of a ray (ascending) are kept
    by rank, an integer selection equal to the reference's top_k. The
    counters skip the padding rows of `ray_live`."""
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    D = q.z_depth_dim
    S = q.coarse_step
    DS = -(-D // S)
    BW = min(q.coarse_win_budget, DS)
    dims = cache.coor_2_qslot.shape
    dims_t = torch.tensor(dims, device=dev)

    def voxel_index(pos):
        gc = to_i32(torch.floor((pos - ranges_min) / scaled_vsize))
        inb = ((gc >= 0) & (gc < dims_t)).all(-1)
        gcc = torch.minimum(torch.clamp(gc, min=0), dims_t - 1).long()
        return (gcc[..., 0] * dims[1] + gcc[..., 1]) * dims[2] + gcc[..., 2], \
            inb

    dw_overflow = None
    if 0 < q.depth_window < D:
        # composed with the depth window: only the windows overlapping
        # [d0, d0 + DW) are tested; dw_overflow counts the in-box samples
        # past them
        DW = q.depth_window
        t_enter, t_exit = slab(raydirs, campos, ranges_min, rmax)
        d_lo = to_i32(torch.floor((t_enter - near) / step_t - 0.5))
        d0 = torch.clamp(d_lo, 0, max(D - DW, 0))
        d_hi = torch.clamp(to_i32(torch.ceil(
            (torch.minimum(t_exit, far) - near) / step_t - 0.5)), max=D - 1)
        hit_box = (t_exit >= t_enter) & (d_hi >= 0)
        if ray_live is not None:
            hit_box = hit_box & ray_live
        w0 = d0 // S
        DS2 = min(DS, DW // S + 1)
        wi = w0[:, None] + torch.arange(DS2, dtype=torch.int32, device=dev)
        w_in = wi < DS
        dw_overflow = torch.where(
            hit_box, torch.clamp(d_hi - ((w0 + DS2) * S - 1), min=0),
            0).sum().to(torch.int32)
    else:
        DS2 = DS
        wi = torch.arange(DS, dtype=torch.int32, device=dev).expand(R, DS)
        w_in = torch.ones((R, DS), dtype=torch.bool, device=dev)
    t_c = near + (wi.to(f32) * S + (S - 1) / 2 + 0.5) * step_t
    cfid, _ = voxel_index(campos + raydirs[:, None, :] * t_c[..., None])
    cocc = cache.coarse_occ.reshape(-1)[cfid] & w_in             # [R, DS2]
    BW = min(BW, DS2)
    rank = torch.cumsum(cocc.to(torch.int32), -1)
    pick = cocc & (rank <= BW)
    # the picked windows to columns rank - 1 (distinct), the rest to a
    # spare column that is dropped; unfilled columns stay DS (no sample)
    w_sel = torch.full((R, BW + 1), DS, dtype=torch.long, device=dev)
    w_sel.scatter_(1, torch.where(pick, rank.long() - 1, BW), wi.long())
    w_sel = w_sel[:, :BW]
    over = torch.clamp(rank[:, -1] - BW, min=0)
    if ray_live is not None:
        over = torch.where(ray_live, over, 0)
    win_overflow = over.sum().to(torch.int32)
    D2 = BW * S
    d_true = (w_sel[:, :, None] * S
              + torch.arange(S, device=dev)).reshape(R, D2)
    in_d = d_true < D
    t_f = near + (d_true.to(f32) + 0.5) * step_t
    ffid, finb = voxel_index(campos + raydirs[:, None, :] * t_f[..., None])
    finb = finb & in_d
    qflat = cache.coor_2_qslot.reshape(-1)
    qs = torch.where(finb, qflat[torch.where(finb, ffid, 0)], -1)
    d_true = torch.clamp(d_true, max=D - 1)
    return qs, d_true, D2, dw_overflow, win_overflow


def _render_span_tiers(params, Rw2c, cache, campos, camrotc2w, raydirs, near,
                       far, cfg, ranges_min, scaled_vsize, bg_ray_colors, bg,
                       rmax, step_t, pshard_axis=None,
                       debug_ablate=None) -> FastRenderOutput:
    """Span-tiered ray packing (QueryConfig.span_tiers; reference
    fast_render.py:694-796): the ray packing with one packed group per
    span tier, each rendered at its own depth-window width (ray budget
    span_tier_budgets[i]), with a compaction budget scaled by the tier's
    width. Rays are disjoint across tiers; miss rays render exact
    background. dw_overflow and rb_overflow are summed over the tiers;
    cb_overflow, win_overflow and pb_overflow too where a tier has them."""
    q = cfg.query
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    D = q.z_depth_dim
    SR = q.SR
    BP = q.ray_slot_budget or min(SR, 32)
    widths = tuple(int(w) for w in q.span_tiers)
    budgets = tuple(int(b) for b in q.span_tier_budgets)
    if len(widths) != len(budgets) or widths != tuple(sorted(widths)):
        raise ValueError("span_tiers must be ascending with matching "
                         "budgets")
    t_enter, t_exit = slab(raydirs, campos, ranges_min, rmax)
    hit = ((t_exit + step_t >= t_enter) & (t_exit >= near - step_t)
           & (t_enter <= far + step_t))
    # the in-box sample span, by the depth window's own float math
    d_lo = to_i32(torch.floor((t_enter - near) / step_t - 0.5))
    d_hi = torch.clamp(to_i32(torch.ceil(
        (torch.minimum(t_exit, far) - near) / step_t - 0.5)), max=D - 1)
    span = torch.where((t_exit >= t_enter) & (d_hi >= 0),
                       d_hi - torch.clamp(d_lo, min=0) + 1, 0)
    ti = torch.zeros(R, dtype=torch.int32, device=dev)
    for w in widths[:-1]:
        ti = ti + (span > w).to(torch.int32)   # the last tier takes the rest
    color = bg.contiguous().clone()
    ray_mask = torch.zeros(R, dtype=torch.bool, device=dev)
    acc = torch.zeros(R, dtype=f32, device=dev)
    depth = torch.zeros(R, dtype=f32, device=dev)
    rb_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    dw_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    lists = {"cb_overflow": [], "win_overflow": [], "pb_overflow": []}
    n_valid = torch.zeros((), dtype=torch.int32, device=dev)
    w_bar = (sum(b * wj for b, wj in zip(budgets, widths))
             / max(sum(budgets), 1))
    for i, w in enumerate(widths):
        rid, valid, over = pack_first(hit & (ti == i), min(budgets[i], R))
        rb_overflow = rb_overflow + over
        # valid samples per ray scale with the span: the global budget is
        # shared in proportion to tier width (cb_overflow counts the rest)
        if q.compact_budget > 0:
            cb_i = max(1, -(-q.compact_budget * w // int(w_bar)))
            cb_i = min(cb_i, SR, BP, w)
        else:
            cb_i = 0
        cfg_i = dataclasses.replace(cfg, query=dataclasses.replace(
            q, span_tiers=(), span_tier_budgets=(), ray_budget=0,
            depth_window=min(w, D), compact_budget=cb_i))
        sub = fast_render_rays(
            params, Rw2c, cache, campos, camrotc2w, raydirs[rid], near, far,
            cfg_i, ranges_min, scaled_vsize, ray_live=valid,
            bg_ray_colors=(None if bg_ray_colors is None
                           else bg_ray_colors[rid]), pshard_axis=pshard_axis,
            debug_ablate=debug_ablate)
        ids = torch.where(valid, rid, R)
        for base, x in ((color, sub.coarse_raycolor), (ray_mask, sub.ray_mask),
                        (acc, sub.acc), (depth, sub.depth)):
            ext = torch.cat([base, base[:1]])
            ext[ids] = x.to(base.dtype)
            base.copy_(ext[:R])
        if sub.dw_overflow is not None:
            dw_overflow = dw_overflow + sub.dw_overflow
        for f, vals in lists.items():
            if getattr(sub, f) is not None:
                vals.append(getattr(sub, f))
        n_valid = n_valid + sub.n_valid_slots
    return FastRenderOutput(
        coarse_raycolor=color, ray_mask=ray_mask, acc=acc, depth=depth,
        dw_overflow=dw_overflow, rb_overflow=rb_overflow,
        n_valid_slots=n_valid,
        **{f: (sum(v) if v else None) for f, v in lists.items()})


def _grid_composite(cfg, sig, rgb, slot_ok, attrs_m, sel_ray, sel_slot,
                    sel_d, ray_hit, raydirs, campos, camrotc2w, near, step_t,
                    BP, bg, counters, scatterback=False) -> FastRenderOutput:
    """The reference's slot-grid composite: the [M] slots scatter to
    [R, BP] rows, then alpha compositing per row. With `attrs_m` (prob
    mode) also each ray's slot of largest opacity (torch.argmax takes the
    first among equals, as jnp.argmax does), its location and the
    neighbour averages of that slot. Its sums run along the slot grid, so
    they may differ from the packed composite's in the last bits. The
    probe `scatterback` broadcasts the first BP slots to every row in
    place of the scatter (wrong values, the composite's real time)."""
    R = raydirs.shape[0]
    dev = raydirs.device
    dest = torch.where(slot_ok, sel_ray * BP + sel_slot, R * BP)

    def grid(x):
        if scatterback:
            return x[None, :BP].expand((R, BP) + x.shape[1:])
        g = torch.zeros((R * BP + 1,) + x.shape[1:], dtype=x.dtype,
                        device=dev)
        g[dest] = x
        return g[:R * BP].reshape((R, BP) + x.shape[1:])

    sig_rb, rgb_rb, valid_rb = grid(sig), grid(rgb), grid(slot_ok)
    d_rb = grid(sel_d.to(torch.int32))
    t_rb = near + (d_rb.to(torch.float32) + 0.5) * step_t
    pos_rb = campos + raydirs[:, None, :] * t_rb[..., None]
    z_rb = w2pers(pos_rb, camrotc2w, campos)[..., 2]
    rgb_sum, acc, depth, opacity = composite_rows(
        sig_rb, rgb_rb, z_rb, valid_rb, cfg.query.vsize[2], cfg.blend_func)
    color = TONE_MAPS[cfg.tonemap_func](rgb_sum + (1 - acc)[..., None] * bg)
    ray_mask = ray_hit & valid_rb.any(-1)
    color = torch.where(ray_mask[:, None], color, bg)
    if attrs_m is None:
        return FastRenderOutput(coarse_raycolor=color, ray_mask=ray_mask,
                                acc=acc, depth=depth, **counters)
    attrs_rb = grid(attrs_m)
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
    """(order [R] int64, n_hit [] int64, span [R] int64) of a frame's rays
    as `render_frame` renders them, as tensors on the rays' device:
    box-hitting rays first, by ascending in-box span, ties in ray order,
    miss rays last. No host read (host inputs are uploaded).

    frame_ray_spans' slab test in float64, op for op, and the order of
    np.lexsort((span, ~hit)) by two stable sorts, so all three equal the
    NumPy twin's bit for bit: IEEE division and no contraction into an
    FMA, and every division by `step` is by a device tensor (CUDA
    computes a tensor over a host scalar as a product with its
    reciprocal). A host planner (ops/march.plan_march) that sizes buckets
    for `render_frame`'s chunks takes its rays in this order."""
    dev = raydirs.device
    f64 = torch.float64
    rd = raydirs.to(f64)
    cp = torch.as_tensor(campos, dtype=f64, device=dev).reshape(3)
    rmin = torch.as_tensor(ranges_min, dtype=f64, device=dev).reshape(3)
    svs = torch.as_tensor(scaled_vsize, dtype=f64, device=dev).reshape(3)
    rmax = rmin + torch.stack([float(d) * svs[k]
                               for k, d in enumerate(dims)])
    near, far = float(near), float(far)
    step = (far - near) / D
    step_t = rd.new_full((), step)
    tiny = torch.where(rd >= 0, rd.new_full((), 1e-9),
                       rd.new_full((), -1e-9))
    inv = torch.reciprocal(torch.where(rd.abs() < 1e-9, tiny, rd))
    ta = (rmin - cp) * inv
    tb = (rmax - cp) * inv
    t_enter = torch.minimum(ta, tb).amax(-1)
    t_exit = torch.maximum(ta, tb).amin(-1)
    d_lo = torch.floor((t_enter - near) / step_t - 0.5).long()
    d_hi = torch.ceil((t_exit.clamp_max(far) - near) / step_t - 0.5
                      ).clamp_max(D - 1).long()
    span_hit = (t_exit >= t_enter) & (d_hi >= 0)
    span = torch.where(span_hit, d_hi - d_lo.clamp_min(0) + 1, 0)
    hit = ((t_exit + step >= t_enter)
           & (t_exit >= near - step) & (t_enter <= far + step))
    by_span = torch.sort(span, stable=True).indices
    miss = (~hit)[by_span].to(torch.uint8)
    order = by_span[torch.sort(miss, stable=True).indices]
    return order, hit.sum(), span


def frame_chunks(order, n_hit, span, chunk: int):
    """(perm [n_chunks * chunk] int64 on the device, [smax] a chunk as host
    ints) of `frame_ray_order`'s outputs, with one host read: n_hit and
    each chunk's largest span come back in one transfer. The hitting rays
    fill ceil(n_hit / chunk) chunks in `order`; where they pass the frame's
    R rays, the last chunk is padded with copies of the last ordered rays
    (order[2R - n_used:], Python's slice: identical outputs land on
    identical targets)."""
    R = order.shape[0]
    n_pad = -(-R // chunk) * chunk
    perm = torch.cat([order, order[R - (n_pad - R):]])
    sp = span[perm]
    rows = -(-sp.shape[0] // chunk)
    sp = torch.cat([sp, sp.new_full((rows * chunk - sp.shape[0],),
                                    torch.iinfo(torch.int64).min)])
    head = torch.cat([n_hit.reshape(1).to(sp.dtype),
                      sp.view(rows, chunk).amax(1)]).tolist()
    n_chunks = -(-head[0] // chunk)
    return perm[:n_chunks * chunk], head[1:1 + n_chunks]


def frame_buffers(R: int, bg_color, bg_ray_colors, dev):
    """A frame's outputs before its chunks land: colour [R, 3] f32 (the
    per-ray background, else `bg_color` filled column by column: no
    upload, so no wait for the card), ray_mask, acc, depth."""
    f32 = torch.float32
    if bg_ray_colors is not None:
        color = bg_ray_colors.to(device=dev, dtype=f32).clone()
    else:
        color = torch.empty((R, 3), dtype=f32, device=dev)
        for k in range(3):
            color[:, k] = float(bg_color[k])
    return (color, torch.zeros(R, dtype=torch.bool, device=dev),
            torch.zeros(R, dtype=f32, device=dev),
            torch.zeros(R, dtype=f32, device=dev))


def measured_depth_window(campos, raydirs, near, far, D: int,
                          ranges_min, dims, scaled_vsize,
                          slack: int = 4) -> int:
    """Tight depth-window length for a known ray set: the max in-box
    span plus slack (dw_overflow == 0 re-verifies it on the device)."""
    span, _ = frame_ray_spans(campos, raydirs, near, far, D,
                              ranges_min, dims, scaled_vsize)
    return int(min(D, int(span.max(initial=0)) + slack))


def measured_span_tiers(campos, raydirs, near, far, D: int, ranges_min,
                        dims, scaled_vsize, widths=None, slack: int = 4,
                        round_to: int = 1024, chunk: int = 0):
    """(widths, budgets) for QueryConfig.span_tiers on a known ray set:
    widths at the span quantiles p50 and p85 rounded up to 16, and the
    largest span plus slack (a width within 16 of the next one dropped);
    budgets, per tier, the largest count of its rays in a `chunk` of rays
    (the whole set by default), +3% rounded up to `round_to`. The
    device's rb_overflow and dw_overflow re-verify both. NumPy."""
    span, hit = frame_ray_spans(campos, raydirs, near, far, D, ranges_min,
                                dims, scaled_vsize)
    s = span[hit & (span > 0)]
    smax = int(s.max(initial=1))
    if widths is None:
        p50, p85 = ((int(np.percentile(s, 50)), int(np.percentile(s, 85)))
                    if s.size else (1, 1))
        widths = [-(-p50 // 16) * 16, -(-p85 // 16) * 16]
    widths = sorted(set(min(int(w), D) for w in widths
                        if int(w) < smax + slack))
    widths.append(min(smax + slack, D))
    widths = [w for w, nxt in zip(widths, widths[1:])
              if nxt - w >= 16] + [widths[-1]]
    ti = np.minimum(np.searchsorted(np.asarray(widths), span, side="left"),
                    len(widths) - 1)
    R = span.shape[0]
    chunk = chunk or R
    n_chunks = max(R // chunk, 1)
    budgets = []
    for i in range(len(widths)):
        cnt = (hit & (ti == i))[:n_chunks * chunk].reshape(
            n_chunks, chunk).sum(-1).max()
        budgets.append(int(min(chunk, max(
            round_to, (int(cnt * 1.03) + round_to - 1) // round_to
            * round_to))))
    return tuple(widths), tuple(budgets)


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
                 render_maker=None,
                 program_cache: Optional[dict] = None,
                 raster: Optional[tuple] = None,
                 bg_ray_colors: Optional[torch.Tensor] = None,
                 verbose: bool = False) -> FastRenderOutput:
    """Full-frame render with frame-level ray packing and per-chunk
    depth-window tiers. Exact (the outputs of rendering the raw ray order
    with depth_window off) while every chunk's counters read zero.

    A frame's rays come from one camera, so about half miss the grid box
    and the rest have widely varying in-box chords:

      1. slab-test every ray on the rays' device, in float64
         (frame_ray_order; frame_ray_spans is its NumPy twin);
      2. sort there: box-hitting rays first, ascending in-box span; miss
         rays render exact background and never enter the pipeline. The
         plan's one host read brings n_hit and each chunk's largest span
         (frame_chunks); the raster's plan reads more;
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
    chunk at that lower compaction budget first. `render_maker(cfg) ->
    fn(rays, bg_or_None)` builds the renderer of a chunk's config (its
    depth-window tier and budget); two-argument renderers are called
    without the raster's rows, and the raster is off, as in the
    reference. A frame calls the maker once per (tier, chunk, budget),
    memoised in `program_cache` under that key; the maker's renderer
    brings its own camera, so to render another camera pass another
    maker or another cache. The default renders each chunk with
    `fast_render_rays` on this call's camera. `program_cache` (a dict
    kept across frames) also holds the scene's qvox table and the raster
    programs by ladder. `bg_ray_colors` [Rtot, 3] (the plane model's
    per-ray background) replaces cfg.bg_color ray by ray. dw_overflow,
    cb_overflow, mc_overflow, win_overflow and pb_overflow are summed over
    chunks; rb_overflow is None
    (the packing happens here, by a conservative slab test that cannot drop
    a hitting ray). On a hash grid's cache the bounds are its logical dims
    and the raster is not used (it bins against the dense qslot table), as
    in the reference.

    While a profiler records (utils/profiling.py), the frame, its plan
    (steps 1-2, the raster, the buffers and the rays' gather), each
    chunk render, each escalation level's wait for the card and the
    scatter are spans `render_frame[.plan|.chunk|.wait|.scatter]`, and
    `render_frame.frames`, `.chunk_renders` and `.rerenders` count."""
    q = cfg.query
    D = q.z_depth_dim
    dev = raydirs.device
    Rtot = raydirs.shape[0]
    frame = profiling.count("render_frame.frames")
    with profiling.span("render_frame", f"frame={frame}"):
        with profiling.span("render_frame.plan"):
            # the camera and rays as float32, as the chunks render them
            perm, smax = frame_chunks(*frame_ray_order(
                torch.as_tensor(campos, dtype=torch.float32, device=dev),
                raydirs.to(torch.float32), near, far, D, ranges_min,
                cache_dims(cache), scaled_vsize), chunk)
            n_chunks = len(smax)

            pcache = program_cache if program_cache is not None else {}
            emit_tbl = None
            front_end = "march" if march_active(q) else "depth_window"
            if (raster is not None and render_maker is None
                    and march_active(q) and cache.hash_table is None):
                try:
                    emit_tbl, _ = frame_raster_emit(
                        cache, campos, camrotc2w, raydirs, near, far, q,
                        ranges_min, scaled_vsize, raster, pcache)
                    front_end = "raster"
                except RasterUnserved as e:
                    if verbose:
                        print(f"render_frame: raster disabled ({e}); "
                              f"walking this frame", file=sys.stderr)

            f32 = torch.float32
            color, ray_mask, acc, depth = frame_buffers(
                Rtot, cfg.bg_color, bg_ray_colors, dev)
            if n_chunks:
                rays_p = raydirs[perm]
                bg_p = None if bg_ray_colors is None else color[perm]

        sums = {f: None for f in ("win_overflow", "dw_overflow",
                                  "cb_overflow", "mc_overflow",
                                  "pb_overflow")}
        if n_chunks:
            def render(i, dw, b):
                profiling.count("render_frame.chunk_renders")
                sl = slice(i * chunk, (i + 1) * chunk)
                cfg_t = dataclasses.replace(cfg, query=dataclasses.replace(
                    q, depth_window=dw, ray_budget=0, compact_budget=b))
                bg_c = None if bg_p is None else bg_p[sl]
                with profiling.span("render_frame.chunk",
                                    f"chunk={i} budget={b} tier={dw}"):
                    if render_maker is not None:
                        key = ("render_maker", dw, chunk, b)
                        if key not in pcache:
                            pcache[key] = render_maker(cfg_t)
                        return pcache[key](rays_p[sl], bg_c)
                    return fast_render_rays(
                        params, Rw2c, cache, campos, camrotc2w, rays_p[sl],
                        near, far, cfg_t, ranges_min, scaled_vsize,
                        premarch=(None if emit_tbl is None
                                  else (emit_tbl, perm[sl])),
                        bg_ray_colors=bg_c)

            b_full = q.compact_budget if q.compact_budget > 0 else q.SR
            b_cap = min(q.SR, q.ray_slot_budget or min(q.SR, 32))
            b_now = budget_tier if 0 < budget_tier < b_full else b_full
            results, dws = [], []
            for i in range(n_chunks):
                tier = min(D, -(-(smax[i] + dw_slack) // tier_quant)
                           * tier_quant)
                dws.append(tier if tier < D else 0)
                results.append(render(i, dws[i], b_now))
            # budget escalation: one deferred device sync per level,
            # usually none or one (the host waits for the card here)
            while b_now < b_cap:
                with profiling.span("render_frame.wait"):
                    trip = [i for i, r in enumerate(results)
                            if r.cb_overflow is not None
                            and int(r.cb_overflow) > 0]
                if not trip:
                    break
                profiling.count("render_frame.rerenders", len(trip))
                b_now = min(max(2 * b_now, b_full), b_cap)
                for i in trip:
                    results[i] = render(i, dws[i], b_now)
            with profiling.span("render_frame.scatter"):
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
