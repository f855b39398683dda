"""Fast eval render path: fat candidate cache + slot compaction + chunk
decode + packed composite.

Port of the served subset of `pointnerf2studio_tpu/models/fast_render.py`:
the kernel-facing cache (the reference's "fused" layout, stored
candidate-major), `build_fat_cache`,
`fit_cand_cap`, `make_fast_scene`, and `fast_render_rays` through

  ray packing (QueryConfig.ray_budget) ->
  dense qslot lookup, optionally clipped to a per-ray depth window ->
  first-BP valid columns per ray (ops/select.py; the CUDA kernel under
  select_mode="pallas") -> rank-gather pack to M = R * compact_budget
  slots -> the chunk decode -> packed alpha composite,

with every exactness counter the reference returns on that path
(dw_overflow, rb_overflow, cb_overflow) and n_valid_slots. The chunk
decode is one of

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

Not ported yet: the "rows" cache layout and the XLA candidate stages,
span tiers, coarse windows, prob mode, pair decode, the plane
background, hash grids and sharding; a config that asks for them raises.

No host synchronisation happens per chunk: ray packing and slot packing
are cumsum/scatter compactions on the device, and the kernels skip
masked slots themselves.
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
    TONE_MAPS, packed_alpha_composite)
from pointnerf2studio_torch.ops.fused_chunk import (
    PK, fused_chunk_decode, fused_chunk_eligible)
from pointnerf2studio_torch.ops.fused_decode import (
    fused_decode2, fused_decode_served, tower_inputs)
from pointnerf2studio_torch.ops.fused_select import fused_candidate_select
from pointnerf2studio_torch.ops.grid import PointGrid
from pointnerf2studio_torch.ops.march import (
    build_march_table, march_rays, slab, to_i32)
from pointnerf2studio_torch.ops.query import neighbor_offsets
from pointnerf2studio_torch.ops.raster import (
    RasterUnserved, _voxel_footprint, build_qvox, make_raster_program)
from pointnerf2studio_torch.ops.select import (
    rank_gather_pack, select_first_cols)

PAYW = 44                 # bf16 payload per candidate: xyz_rel(3) +
                          # emb(32) + conf(1) + dir(3) + color(3) + pad(2)
ROWW = 1 + PAYW // 2      # f32 words per candidate in the "rows" layout
TAIL_CHUNK = 1 << 16      # slots per piece of the decode_radiance tail


@dataclasses.dataclass
class FatCache:
    """Per-query-voxel candidate rows, laid out for the card's kernels.

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
    Candidates are ordered by (Chebyshev shell, distance to the voxel
    centre) as the reference's f32 key orders them.
    march_table [gx, gy, gz] int32 (ops/march.build_march_table): the
    qslot table packed with a Chebyshev distance field, present when the
    config routes the front-end through the march.
    """
    coor_2_qslot: torch.Tensor     # [gx, gy, gz] int32, -1 = not query
    kmeta: torch.Tensor            # [max_q, C] int32
    kcand: torch.Tensor            # [max_q, C, PK] bf16
    kxyz: torch.Tensor             # [max_q, 3, C] bf16
    n_q: torch.Tensor              # [] int32
    march_table: Optional[torch.Tensor] = None

    @property
    def cand(self) -> int:
        return self.kmeta.shape[1]

    @property
    def kpay(self) -> torch.Tensor:
        return self.kcand.transpose(1, 2)


def query_voxels(grid: PointGrid, max_q: int):
    """The query voxels of a grid as the caches number them: (coor_2_qslot
    [gx, gy, gz] int32, -1 = not a query voxel; n_q [] int32; q_coor
    [max_q, 3] int64; q_live [max_q] bool; center_w [max_q, 3] f32, each
    voxel's centre)."""
    dev = grid.coor_occ.device
    gx, gy, gz = grid.dims
    nvox = gx * gy * gz
    occ_flat = grid.coor_occ.reshape(-1)
    qslot = torch.cumsum(occ_flat.long(), 0) - 1
    n_q = occ_flat.sum().to(torch.int32)
    valid_q = occ_flat & (qslot < max_q)
    coor_2_qslot = torch.where(valid_q, qslot, -1).to(torch.int32).reshape(
        grid.dims)
    q_flat = torch.full((max_q,), nvox, dtype=torch.long, device=dev)
    live_ids = torch.nonzero(valid_q).squeeze(1)
    q_flat[:live_ids.shape[0]] = live_ids
    q_coor = torch.stack([q_flat // (gy * gz), (q_flat // gz) % gy,
                          q_flat % gz], -1)
    # one rounding of rmin + (q + 0.5) * svs, as the reference's compiled
    # build gets from a fused multiply-add; the relative xyz of both caches
    # inherit this value bit for bit
    center_w = (grid.ranges_min.double() + (q_coor.double() + 0.5)
                * grid.scaled_vsize.double()).float()
    return coor_2_qslot, n_q, q_coor, q_flat < nvox, center_w


def ordered_candidates(grid: PointGrid, xyz: torch.Tensor,
                       kernel_size: Tuple[int, int, int], C: int,
                       qc: torch.Tensor, cw: torch.Tensor,
                       live: torch.Tensor):
    """The first C candidates of each query voxel of a chunk (coordinates
    qc [B, 3], centres cw [B, 3], live [B]): (sel_ok [B, C] bool, sel_pidx
    [B, C] int64, sel_sh [B, C] int64 Chebyshev shell, sel_xyz [B, C, 3]).

    Candidate order is the reference's f32 key shell * 1e12 + min(d2,
    1e9), sorted stably: beyond shell 0 the d2 term is below one ulp of
    the shell term, so outer-shell candidates keep their scan order. Both
    caches (this module's and models/fast_train.py's) take it from here."""
    dev = xyz.device
    offs_np, shells_np = neighbor_offsets(kernel_size)
    offsets = torch.as_tensor(offs_np, dtype=torch.long, device=dev)
    shells = torch.as_tensor(shells_np, dtype=torch.long, device=dev)
    V = offsets.shape[0]
    P = grid.occ_2_pnts.shape[1]
    _, gy, gz = grid.dims
    dims_t = torch.tensor(grid.dims, device=dev)
    N = xyz.shape[0]
    B = qc.shape[0]
    nb = qc[:, None, :] + offsets[None]                         # [B, V, 3]
    inb = ((nb >= 0) & (nb < dims_t)).all(-1) & live[:, None]
    nbc = torch.minimum(torch.clamp(nb, min=0), dims_t - 1)
    slot = grid.coor_2_occ.reshape(-1)[
        (nbc[..., 0] * gy + nbc[..., 1]) * gz + nbc[..., 2]]
    slot_ok = inb & (slot >= 0)
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


def cand_width(grid: PointGrid, kernel_size: Tuple[int, int, int],
               cand_cap: int) -> int:
    """C = min(cand_cap, candidates a voxel's neighbourhood can hold)."""
    V = neighbor_offsets(kernel_size)[0].shape[0]
    return min(cand_cap, V * grid.occ_2_pnts.shape[1])


@torch.no_grad()
def build_fat_cache(grid: PointGrid, cloud: NeuralPointCloud,
                    kernel_size: Tuple[int, int, int], max_q: int,
                    cand_cap: int = 64, chunk: int = 32768) -> FatCache:
    """Build the candidate cache for the kernels (the content of the
    reference's layout="fused", stored candidate-major: see `FatCache`;
    the "rows" layout is not ported), once per point/attribute change.
    Candidates in the order of `ordered_candidates`."""
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
    for s in range(0, max_q, chunk):
        cw = center_w[s:s + chunk]
        sel_ok, sel_pidx, sel_sh, sel_xyz = ordered_candidates(
            grid, cloud.xyz, kernel_size, C, q_coor[s:s + chunk], cw,
            q_live[s:s + chunk])
        B = cw.shape[0]
        rel = (sel_xyz - cw[:, None, :]).to(torch.bfloat16)     # [B, C, 3]
        kmeta[s:s + B] = torch.where(sel_ok, sel_pidx * 4 + sel_sh,
                                     -1).to(torch.int32)
        sel_attr = attrs[torch.clamp(sel_pidx, 0, N - 1)]       # [B, C, 39]
        kcand[s:s + B] = torch.cat(
            [rel, sel_attr, rel.new_zeros((B, C, PK - 42))], -1)
        kxyz[s:s + B] = rel.transpose(1, 2)
    return FatCache(coor_2_qslot=coor_2_qslot, kmeta=kmeta, kcand=kcand,
                    kxyz=kxyz, n_q=n_q)


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
    if "fused" not in (q.knn_mode, q.chunk_mode):
        raise NotImplementedError(
            "only the kernel-facing cache layout is ported: set "
            "QueryConfig.chunk_mode='fused'")
    if max_q is None:
        nq = int(grid.coor_occ.sum())
        max_q = (nq + 32767) // 32768 * 32768
    cc = fit_cand_cap(max_q, q.cand_cap, device=cloud.xyz.device)
    cache = build_fat_cache(grid, cloud, q.kernel_size, max_q, cc)
    if march_active(q):
        cache.march_table = build_march_table(cache.coor_2_qslot)
    return cache, grid.ranges_min, grid.scaled_vsize


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
    """"chunk" (the fused chunk kernel) or "staged" (select kernel +
    decode tail) for a config the port serves; raises otherwise."""
    q = cfg.query
    whole = (q.chunk_mode == "fused" and not _use_fused2(cfg)
             and fused_chunk_eligible(cfg.agg, Rw2c.ndim == 4, q.K))
    staged = q.chunk_mode == "xla" and q.knn_mode == "fused"
    unported = {
        "span_tiers": bool(q.span_tiers), "coarse_step": q.coarse_step > 1,
        "compact_mode": q.compact_mode != "topk",
        "composite_mode": q.composite_mode != "packed",
        "chunk_mode/knn_mode/agg": not (whole or staged),
        "decode_mode": q.decode_mode != "lanes",
        "base_cache": q.base_cache,
        "per-point Rw2c": Rw2c.ndim != 2,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"fast_render_rays: not ported for this config ({bad}); the "
            f"port serves depth_window/ray_budget or march_steps + topk "
            f"compaction + packed composite with chunk_mode='fused' (an "
            f"eligible "
            f"aggregator, fused_decode2 off) or with knn_mode='fused', "
            f"chunk_mode='xla'")
    return "chunk" if whole else "staged"


def _decode_tail(params: Aggregator, cfg: PointNerfConfig, Rw2c, camrotc2w,
                 campos, nsel, pnt_mask, locs, center, rd_sel):
    """(sigma [M], rgb [M, 3], found [M]) from the selected payloads
    nsel [M, K, >= 42] bf16: neighbour geometry, aggregation weights,
    then the tower (the reference's `_decode_tail`)."""
    f32 = torch.float32
    nxyz = nsel[..., :3].to(f32) + center[:, None, :]           # [M, K, 3]
    # attribute slices stay bf16 end to end, as in the reference
    emb = nsel[..., 3:35]
    conf = nsel[..., 35].to(f32)
    ndir = nsel[..., 36:39]
    ncol = nsel[..., 39:42]
    dists = neighbor_dists(nxyz, locs, camrotc2w, campos)
    weight, emb = aggregation_weight(cfg.agg, emb, dists, pnt_mask,
                                     max(cfg.query.scaled_vsize), params)
    if cfg.agg.conf_in_weight:
        weight = weight * conf
    vd = rotate(rd_sel, Rw2c)
    if _use_fused2(cfg):
        dists_rot, dirdot, wk, dir_pe = tower_inputs(
            cfg.agg, dists, ndir, vd, weight, pnt_mask, Rw2c)
        sig, rgb = fused_decode2(
            params, emb, dists_rot, ncol, dirdot, wk, dir_pe,
            cfg.agg.num_feat_freqs, cfg.agg.num_dist_freqs)
    else:
        sig, rgb = decode_radiance(
            params, cfg.agg, neigh_emb=emb, neigh_color=ncol,
            neigh_dir=ndir, dists=dists, weight=weight, pnt_mask=pnt_mask,
            viewdirs=vd, Rw2c=Rw2c)
    return sig, rgb, pnt_mask.any(-1)


def pack_hit_rays(cache, campos, raydirs, near, far, q, ranges_min,
                  scaled_vsize, jitter: float = 0.0):
    """Ray packing of one chunk: (ray_ids [RB] long, valid [RB] bool,
    rb_overflow [] int32) for RB = min(q.ray_budget, R). `ray_ids` holds
    the first RB box-hitting rays in ray order (cumsum + scatter, no
    sync); the padding rows repeat ray 0, as in the reference, and are
    False in `valid`. `jitter` (the train path's) widens the far margin
    by jitter/2 * (far - near): jittered segment lengths sum past far.
    `cache` is a FatCache or a GeoCache (its qslot table sizes the box)."""
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    RB = min(q.ray_budget, R)
    near = torch.as_tensor(near, dtype=f32, device=dev)
    far = torch.as_tensor(far, dtype=f32, device=dev)
    step_t = (far - near) / q.z_depth_dim
    dims_f = torch.tensor(cache.coor_2_qslot.shape, device=dev).to(f32)
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


def qslot_lookup(coor_2_qslot: torch.Tensor, pos: torch.Tensor,
                 ranges_min: torch.Tensor, scaled_vsize: torch.Tensor
                 ) -> torch.Tensor:
    """The qslot of the voxel each position [..., 3] lies in, -1 outside
    the grid or outside every query voxel."""
    dims = coor_2_qslot.shape
    dims_t = torch.tensor(dims, device=pos.device)
    gc = torch.floor((pos - ranges_min) / scaled_vsize).to(torch.int32)
    inb = ((gc >= 0) & (gc < dims_t)).all(-1)
    gcc = torch.minimum(torch.clamp(gc, min=0), dims_t - 1).long()
    fi = (gcc[..., 0] * dims[1] + gcc[..., 1]) * dims[2] + gcc[..., 2]
    qslot_flat = coor_2_qslot.reshape(-1)
    return torch.where(inb, qslot_flat[torch.where(inb, fi, 0)], -1)


def march_args(cache: FatCache, campos, raydirs, near, far, q, ranges_min,
               scaled_vsize, ray_live=None) -> dict:
    """The keyword arguments `fast_render_rays` gives `march_rays` for
    these rays under query config `q`; raises where the cache or the
    packing cannot serve the walk."""
    if cache.march_table is None:
        raise ValueError(
            "march_steps needs a cache with march_table "
            "(make_fast_scene builds it when march_steps is set)")
    D = q.z_depth_dim
    if cache.kmeta.shape[0] > (1 << 22) - 2 or D > 512:
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
) -> FastRenderOutput:
    """Render R rays through the fast path (see the module docstring)."""
    route = _check_served(cfg, Rw2c)
    q = cfg.query
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
    dims_f = torch.tensor(cache.coor_2_qslot.shape, device=dev).to(f32)
    near = torch.as_tensor(near, dtype=f32, device=dev)
    far = torch.as_tensor(far, dtype=f32, device=dev)
    step_t = (far - near) / D
    rmax = ranges_min + dims_f * scaled_vsize
    bg = torch.as_tensor(cfg.bg_color, dtype=f32, device=dev)

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
                                         else premarch[ray_ids]))
        ids = torch.where(valid, ray_ids, R)       # padding rows drop

        def scatter(base, x):
            out = torch.cat([base, base[:1]])
            out[ids] = x.to(base.dtype)
            return out[:R]

        return FastRenderOutput(
            coarse_raycolor=scatter(bg.expand(R, 3).contiguous(),
                                    sub.coarse_raycolor),
            ray_mask=scatter(torch.zeros(R, dtype=torch.bool, device=dev),
                             sub.ray_mask),
            acc=scatter(torch.zeros(R, dtype=f32, device=dev), sub.acc),
            depth=scatter(torch.zeros(R, dtype=f32, device=dev), sub.depth),
            dw_overflow=sub.dw_overflow, rb_overflow=rb_overflow,
            cb_overflow=sub.cb_overflow, mc_overflow=sub.mc_overflow,
            n_valid_slots=sub.n_valid_slots)

    def qs_lookup(pos):
        return qslot_lookup(cache.coor_2_qslot, pos, ranges_min,
                            scaled_vsize)

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
            if cache.kmeta.shape[0] > (1 << 22) - 2:
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
        sel_ray, _, _, _, packed_m, mask_c = rank_gather_pack(
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
        sel_ray, _, colm, _, qslot_c, mask_c = rank_gather_pack(
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
    else:
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

    # ---- packed composite
    slot_ok = mask_c & found
    sig = sig * slot_ok.to(sig.dtype)
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
        qv = build_qvox(cache.coor_2_qslot, cache.kmeta.shape[0])
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
    saves the device pull. dw_overflow, cb_overflow and mc_overflow are
    summed over chunks; rb_overflow is None (the packing happens here, by
    a conservative slab test that cannot drop a hitting ray). Unlike the
    reference there is no `render_maker` or `bg_ray_colors`: the port has
    no sharded renderer and no plane background."""
    q = cfg.query
    D = q.z_depth_dim
    dev = raydirs.device
    Rtot = raydirs.shape[0]
    dims = tuple(cache.coor_2_qslot.shape)
    rd_np = _np(host_rays if host_rays is not None else raydirs, np.float32)
    order, n_hit, span = frame_ray_order(
        _np(campos, np.float32), rd_np, near, far, D, ranges_min, dims,
        scaled_vsize)

    pcache = program_cache if program_cache is not None else {}
    emit_tbl = None
    front_end = "march" if march_active(q) else "depth_window"
    if raster is not None and march_active(q):
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
    bg = torch.as_tensor(cfg.bg_color, dtype=f32, device=dev)
    color = bg.expand(Rtot, 3).contiguous()
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
        span_sorted = span[order[:n_used]]

        def render(i, dw, b):
            sl = slice(i * chunk, (i + 1) * chunk)
            cfg_t = dataclasses.replace(cfg, query=dataclasses.replace(
                q, depth_window=dw, ray_budget=0, compact_budget=b))
            return fast_render_rays(
                params, Rw2c, cache, campos, camrotc2w, rays_p[sl], near,
                far, cfg_t, ranges_min, scaled_vsize,
                premarch=None if emit_tbl is None else (emit_tbl, perm[sl]))

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
