"""Differentiable fast train path: the fast render path's structure with
gradients flowing into the point attributes and the MLP tower.

Port of `pointnerf2studio_tpu/models/fast_train.py`, on a dense grid or
a sparse hash grid (ops/hash_grid.py; `make_hash_geo_scene`). The
render path's fat cache bakes bf16 point attributes into its candidate
rows, which cuts the gradients; here the cache carries geometry only
(`GeoCache`: candidate ids and float32 offsets), and the attributes are
gathered from the cloud after the K-nearest selection, so their gradient
flows back through that gather. Selection (qslot lookup, column
compaction, K-nearest) is integer comparisons and indices, with no
gradient by construction.

  jittered raygen -> front-end: the dense [R, D] qslot lookup with the
  first-BP valid columns per ray (ops/select.py; the CUDA kernel
  first_valid_cols under select_mode="pallas"; on a hash grid each
  sample's qslot comes from the bucket table), or, on a dense grid, the
  jitter-aware distance-field walk (ops/march.py; the CUDA kernel
  march_rays) under QueryConfig.march_steps -> rank-gather pack to
  M = R * compact_budget
  slots -> chunks of `fast_chunk` slots: geometry gather, layered
  K-nearest, differentiable attribute gather, weights, the tower
  (models/aggregator.decode_radiance) -> packed composite.

The chunk body is plain tensor code under torch autograd: the reference
computes it with XLA too (its Pallas kernels are forward-only). Every
chunk is computed, none skipped, so a step reads nothing back to the host.
Gradients do not depend on launch order: the attribute gather is
`models/neural_points.gather_rows`, whose backward is a stable sort, one
flat float64 prefix scan and one write a row; no atomic accumulation
sits on the gradient's path.

`bg_ray_colors` (the plane model's per-ray background) replaces
cfg.bg_color where given.

The reference's opt-in train routes are here too: the one-hot
compaction (compact_mode="onehot", an integer selection), the slot-grid
composite (composite_mode="grid"), `TrainConfig.remat` ("selection"
recomputes the decode from the saved selection in the backward, "full"
the whole chunk, both through torch.utils.checkpoint with gradients
equal to "none" bit for bit) and the perf probes (`debug_prefix`). A
per-point Rw2c raises, as in the reference: edited scenes train through
the legacy step (train/trainer.make_train_step). `make_geo_scene` raises where the reference would retry
an out-of-memory build at half the candidate width.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import (
    Aggregator, aggregation_weight, conf_gradient_clamp, decode_radiance)
from pointnerf2studio_torch.models.fast_render import (
    cand_width, candidate_pieces, fit_cand_cap, march_active,
    onehot_compact, pack_hit_rays, qslot_lookup, query_voxels)
from pointnerf2studio_torch.ops.hash_grid import HashGrid
from pointnerf2studio_torch.models.neural_points import (
    NeuralPointCloud, gather_attrs, gather_rows)
from pointnerf2studio_torch.ops.camera import neighbor_dists, rotate, w2pers
from pointnerf2studio_torch.ops.compositing import (
    TONE_MAPS, composite_rows, packed_alpha_composite)
from pointnerf2studio_torch.ops.grid import PointGrid
from pointnerf2studio_torch.ops.march import build_march_table, march_rays
from pointnerf2studio_torch.ops.query import (
    candidate_keep_mask, layered_k_nearest)
from pointnerf2studio_torch.ops.raygen import (
    jitter_uniform, near_far_disparity_linear_ray_generation,
    near_far_linear_ray_generation)
from pointnerf2studio_torch.ops.select import (
    rank_gather_pack, select_first_cols)
from pointnerf2studio_torch.utils import profiling

GEOW = 4      # words per candidate (meta + xyz offset), as the reference sizes it


@dataclasses.dataclass
class GeoCache:
    """Per-query-voxel candidate geometry (the render path's FatCache
    without the attributes).

    meta [max_q, C] int32: pidx * 4 + Chebyshev shell, -1 for an empty
    slot; rel [max_q, C, 3] float32: the candidate's xyz relative to the
    query voxel's centre. Candidates in the order of
    `fast_render.ordered_candidates`, the fat cache's order. march_table
    (ops/march.build_march_table) is set when the config routes the
    front-end through the march. On a hash grid `hash_table` and
    `logical_dims` take coor_2_qslot's place (None), as in FatCache."""
    coor_2_qslot: Optional[torch.Tensor]   # [gx, gy, gz] int32, -1 = not
                                           # query; None on a hash grid
    meta: torch.Tensor               # [max_q, C] int32
    rel: torch.Tensor                # [max_q, C, 3] float32
    n_q: torch.Tensor                # [] int32
    march_table: Optional[torch.Tensor] = None
    hash_table: Optional[torch.Tensor] = None      # [B, S * 5] int32
    logical_dims: Optional[Tuple[int, int, int]] = None

    @property
    def cand(self) -> int:
        return self.meta.shape[1]


@torch.no_grad()
def build_geo_cache(grid, xyz: torch.Tensor,
                    kernel_size: Tuple[int, int, int], max_q: int,
                    cand_cap: int = 64, chunk: int = 32768,
                    cand_prune: bool = False, radius2: float = 0.0,
                    knn_k: int = 8) -> GeoCache:
    """Per-query-voxel candidate geometry of a PointGrid or a HashGrid
    (rebuild when points move). `cand_prune` moves the candidates that
    `candidate_keep_mask` keeps to the front, in their order, and marks
    the rest empty."""
    dev = xyz.device
    C = cand_width(grid, kernel_size, cand_cap)
    coor_2_qslot, n_q, q_coor, q_live, center_w = query_voxels(grid, max_q)
    meta = torch.empty((max_q, C), dtype=torch.int32, device=dev)
    rel = torch.empty((max_q, C, 3), dtype=torch.float32, device=dev)
    half = grid.scaled_vsize * 0.5
    max_shell = (kernel_size[0] + 1) // 2 - 1
    iota = torch.arange(C, device=dev)
    for sl, (sel_ok, sel_pidx, sel_sh, sel_xyz) in candidate_pieces(
            grid, xyz, kernel_size, C, q_coor, center_w, q_live, chunk):
        B = sel_ok.shape[0]
        cw = center_w[sl][:B]
        r = sel_xyz - cw[:, None, :]
        if cand_prune:
            keep = candidate_keep_mask(r, sel_sh, sel_ok, half, radius2,
                                       knn_k, max_shell)
            okey = torch.where(keep, iota, C + 1)
            pos = torch.sort(okey, dim=-1, stable=True).indices
            sel_ok = torch.gather(keep, 1, pos)
            sel_pidx = torch.gather(sel_pidx, 1, pos)
            sel_sh = torch.gather(sel_sh, 1, pos)
            r = torch.gather(r, 1, pos[..., None].expand(B, C, 3))
        meta[sl] = torch.where(sel_ok, sel_pidx * 4 + sel_sh,
                               -1).to(torch.int32)
        rel[sl] = r
    hashed = isinstance(grid, HashGrid)
    return GeoCache(coor_2_qslot=coor_2_qslot, meta=meta, rel=rel, n_q=n_q,
                    hash_table=grid.table if hashed else None,
                    logical_dims=grid.dims if hashed else None)


def build_geo_cache_hash(hg: HashGrid, xyz: torch.Tensor,
                         kernel_size: Tuple[int, int, int], max_q: int,
                         cand_cap: int = 64, chunk: int = 32768) -> GeoCache:
    """The geometry cache over a sparse HashGrid: the rows of
    `build_geo_cache` (same qslot numbering and candidate order; see
    models/fast_render.build_fat_cache_hash), with no candidate pruning,
    as in the reference."""
    return build_geo_cache(hg, xyz, kernel_size, max_q, cand_cap, chunk)


def make_hash_geo_scene(cfg: PointNerfConfig, cloud: NeuralPointCloud,
                        hg: HashGrid, max_q: Optional[int] = None):
    """The geometry cache of a scene on a hash grid; returns (geo,
    ranges_min, scaled_vsize), as make_geo_scene does on a dense grid.
    max_q defaults to n_q rounded up to a multiple of 32768."""
    if max_q is None:
        nq = int(hg.n_q)
        max_q = (nq + 32767) // 32768 * 32768
    geo = build_geo_cache_hash(hg, cloud.xyz, cfg.query.kernel_size, max_q,
                               cfg.query.cand_cap)
    return geo, hg.ranges_min, hg.scaled_vsize


def make_geo_scene(cfg: PointNerfConfig, cloud: NeuralPointCloud,
                   grid: PointGrid, max_q: Optional[int] = None):
    """Build the geometry cache of a scene; returns (geo, ranges_min,
    scaled_vsize). max_q defaults to the query-voxel count rounded up to
    a multiple of 32768. A build that runs out of device memory raises
    (the reference retries at half the candidate width, which silently
    changes the result); `fit_cand_cap` still fences the configured width
    against the device's memory up front, as the reference does."""
    q = cfg.query
    if max_q is None:
        nq = int(grid.coor_occ.sum())
        max_q = (nq + 32767) // 32768 * 32768
    cc = fit_cand_cap(max_q, q.cand_cap, device=cloud.xyz.device,
                      row_words=GEOW, what="train geo cache")
    geo = build_geo_cache(grid, cloud.xyz, q.kernel_size, max_q, cc,
                          cand_prune=q.cand_prune,
                          radius2=float(q.radius_limit) ** 2, knn_k=q.K)
    if q.cand_prune:
        C = geo.cand
        c2 = int((geo.meta >= 0).sum(-1).max())
        c2 = min(C, max(8, -(-c2 // 8) * 8))
        if c2 < C:
            geo.meta = geo.meta[:, :c2].contiguous()
            geo.rel = geo.rel[:, :c2].contiguous()
    if q.march_steps:
        geo.march_table = build_march_table(geo.coor_2_qslot)
    return geo, grid.ranges_min, grid.scaled_vsize


@dataclasses.dataclass
class TrainRenderOutput:
    coarse_raycolor: torch.Tensor          # [R, 3]
    ray_mask: torch.Tensor                 # [R] bool
    acc: torch.Tensor                      # [R]
    depth: torch.Tensor                    # [R]
    conf_coefficient: torch.Tensor         # [M, K] (clamped) conf
    pnt_mask: torch.Tensor                 # [M, K] bool
    weight: torch.Tensor                   # [M, K] aggregation weights
    # box-hitting rays past ray_budget (None when packing is off)
    rb_overflow: Optional[torch.Tensor] = None
    # march front-end: rays left unfinished in the staged fuel and
    # buckets (None when the march is off)
    mc_overflow: Optional[torch.Tensor] = None


PREFIXES = ("draw", "mid", "raygen", "front", "gather", "knn", "attrs",
            "decode")


def _check_served(cfg: PointNerfConfig, points: NeuralPointCloud,
                  training: bool, debug_prefix) -> None:
    q = cfg.query
    if points.Rw2c.ndim != 2:
        # as in the reference: edited scenes train on the legacy path
        raise NotImplementedError(
            "fast_train_render: a per-point Rw2c (edited scenes) trains "
            "through the legacy step, fit(fast_path=False), as in the "
            "reference, whose fast step has no per-point rotation either")
    if cfg.train.remat not in ("none", "selection", "full"):
        raise ValueError(f"unknown TrainConfig.remat {cfg.train.remat!r}")
    if debug_prefix is not None and debug_prefix not in PREFIXES:
        raise ValueError(f"unknown debug_prefix {debug_prefix!r}; the "
                         f"cut-offs are {PREFIXES}")


def _chunk_select(cfg: PointNerfConfig, geo: GeoCache, campos, raydirs,
                  t_flat, ranges_min, scaled_vsize, qslot_c, sel_ray, sel_rd,
                  mask_c, debug_prefix=None):
    """The selection half of a chunk: geometry gather, layered K-nearest.
    Returns (pnt_mask [Mc, K], pidx [Mc, K], nxyz [Mc, K, 3], locs [Mc,
    3], rd_sel [Mc, 3]), none of them with a gradient; under the "gather"
    and "knn" cut-offs the reference's probe outputs instead."""
    q = cfg.query
    K = q.K
    num_shells = (q.kernel_size[0] + 1) // 2
    radius2 = q.radius_limit ** 2
    meta = geo.meta[qslot_c]                                    # [Mc, C]
    shell = meta & 3
    rel = geo.rel[qslot_c]                                      # [Mc, C, 3]
    Mc = meta.shape[0]
    if debug_prefix == "gather":
        z = rel.sum((-1, -2)) + meta.float().sum(-1)
        return _probe_rows(z, mask_c, K)
    rd_sel = raydirs[sel_ray]
    locs = campos + rd_sel * t_flat[sel_rd][:, None]            # [Mc, 3]
    vox = torch.floor((locs - ranges_min) / scaled_vsize)
    center = ranges_min + (vox + 0.5) * scaled_vsize
    cdelta = rel + (center - locs)[:, None, :]
    d2 = (cdelta[..., 0] * cdelta[..., 0] + cdelta[..., 1] * cdelta[..., 1]
          + cdelta[..., 2] * cdelta[..., 2])
    ok = (meta >= 0) & mask_c[:, None]
    if radius2 > 0:
        ok = ok & (d2 <= radius2)
    # the K smallest d2, ties to the smallest column (lax.top_k's order)
    top_idx, pnt_mask = layered_k_nearest(d2, ok, shell, K, num_shells,
                                          q.layered_search)
    if debug_prefix == "knn":
        z = torch.where(pnt_mask, torch.gather(d2, 1, top_idx), 0.0).sum(-1)
        return _probe_rows(z, pnt_mask.any(-1), K, pnt_mask=pnt_mask)
    pidx = torch.gather(meta >> 2, 1, top_idx)                  # [Mc, K]
    nxyz = (torch.gather(rel, 1, top_idx[..., None].expand(Mc, K, 3))
            + center[:, None, :])                               # [Mc, K, 3]
    return pnt_mask, pidx, nxyz, locs, rd_sel


def _probe_rows(z, found, K, pnt_mask=None, conf=None):
    """A chunk's outputs at a probe cut-off, as the reference returns
    them: (z, z on 3 channels, found, conf or zeros, pnt_mask or zeros,
    zero weights)."""
    Mc = z.shape[0]
    zk = z.new_zeros((Mc, K))
    return (z, z[:, None].expand(Mc, 3), found,
            zk if conf is None else conf,
            (torch.zeros((Mc, K), dtype=torch.bool, device=z.device)
             if pnt_mask is None else pnt_mask), zk)


def _chunk_decode(params: Aggregator, cfg: PointNerfConfig,
                  points: NeuralPointCloud, attrs: torch.Tensor,
                  points_axis, campos, camrotc2w, training: bool, pnt_mask,
                  pidx, nxyz, locs, rd_sel, debug_prefix=None):
    """The decode half of a chunk: the differentiable attribute gather
    (row-sharded over `points_axis` where given), the weights and the
    tower. Returns (sigma, rgb, found, conf, pnt_mask, weight)."""
    q = cfg.query
    CA = points.points_embeding.shape[-1]
    vals = gather_attrs(attrs, pidx, points_axis)               # [Mc,K,39]
    emb = vals[..., :CA]
    conf = vals[..., CA]
    ndir = vals[..., CA + 1:CA + 4]
    ncol = vals[..., CA + 4:CA + 7]
    if debug_prefix == "attrs":
        z = vals.float().sum((-1, -2)) + nxyz.sum((-1, -2))
        return _probe_rows(z, pnt_mask.any(-1), q.K, pnt_mask=pnt_mask,
                           conf=conf)
    dists = neighbor_dists(nxyz, locs, camrotc2w, campos)
    weight, emb2 = aggregation_weight(cfg.agg, emb, dists, pnt_mask,
                                      max(q.scaled_vsize), params)
    conf_c = conf_gradient_clamp(conf) if training else conf
    if cfg.agg.conf_in_weight:
        weight = weight * conf_c
    vd = rotate(rd_sel, points.Rw2c)
    sig, rgb = decode_radiance(
        params, cfg.agg, neigh_emb=emb2, neigh_color=ncol, neigh_dir=ndir,
        dists=dists, weight=weight, pnt_mask=pnt_mask, viewdirs=vd,
        Rw2c=points.Rw2c)
    return sig, rgb, pnt_mask.any(-1), conf_c, pnt_mask, weight


def _chunk_body(params: Aggregator, cfg: PointNerfConfig,
                points: NeuralPointCloud, attrs: torch.Tensor, points_axis,
                geo: GeoCache, campos, camrotc2w, raydirs, t_flat,
                ranges_min, scaled_vsize, training: bool,
                qslot_c, sel_ray, sel_rd, mask_c, debug_prefix=None):
    """One chunk of slots: the selection (`_chunk_select`), then the
    decode (`_chunk_decode`). Returns (sigma, rgb, found, conf, pnt_mask,
    weight). Under TrainConfig.remat "selection" the decode runs under
    torch.utils.checkpoint (its activations recomputed in the backward
    from the saved selection); "full" wraps the whole body, selection
    included, by the caller."""
    sel = _chunk_select(cfg, geo, campos, raydirs, t_flat, ranges_min,
                        scaled_vsize, qslot_c, sel_ray, sel_rd, mask_c,
                        debug_prefix)
    if debug_prefix in ("gather", "knn"):
        return sel
    if training and cfg.train.remat == "selection":
        return checkpoint(_chunk_decode, params, cfg, points, attrs,
                          points_axis, campos, camrotc2w, training, *sel,
                          debug_prefix, use_reentrant=False)
    return _chunk_decode(params, cfg, points, attrs, points_axis, campos,
                         camrotc2w, training, *sel, debug_prefix)


def fast_train_render(
    params: Aggregator,
    points: NeuralPointCloud,
    geo: GeoCache,
    campos: torch.Tensor,               # [3]
    camrotc2w: torch.Tensor,            # [3, 3]
    raydirs: torch.Tensor,              # [R, 3]
    near,
    far,
    cfg: PointNerfConfig,
    ranges_min: torch.Tensor,
    scaled_vsize: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    jitter_u: Optional[torch.Tensor] = None,    # [R, D] jitter draws
    ray_live: Optional[torch.Tensor] = None,    # [R] bool real-ray rows
    debug_prefix: Optional[str] = None,
    bg_ray_colors: Optional[torch.Tensor] = None,   # [R, 3] per-ray bg
    points_axis=None,
) -> TrainRenderOutput:
    """Render R rays through the differentiable fast path (see the module
    docstring). Jitter (cfg.train.jitter, training only) takes its draws
    from `jitter_u` where given, else from `generator`; with neither the
    samples sit at the segment midpoints. Differentiable in `params` and
    in the cloud's trainable attributes.

    `debug_prefix` (the reference's perf probes) cuts the step after a
    stage and returns the reference's probe outputs, reductions of what
    the stages computed, wrong as a render and equal in shape: "draw"
    (the jitter draw and the ray packing; under ray_budget only), "mid"
    (the jittered sample ts), "raygen" (the sample positions), "front"
    (the compaction), "gather", "knn" and "attrs" (inside each chunk,
    then the composite runs on the probe rows) and "decode" (after the
    chunks).

    With `points_axis` (a parallel/sharding.Axis) the cloud's trainable
    attributes are this rank's rows of a cloud row-sharded over that
    axis, and the attribute gather completes with a psum over it
    (`neural_points.gather_attrs`)."""
    _check_served(cfg, points, training, debug_prefix)
    q = cfg.query
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    D = q.z_depth_dim
    SR, K = q.SR, q.K
    BP = min(q.ray_slot_budget or SR, SR)
    budget = q.compact_budget if q.compact_budget > 0 else SR
    M = min(R * budget, R * D)
    near = torch.as_tensor(near, dtype=f32, device=dev)
    far = torch.as_tensor(far, dtype=f32, device=dev)
    jit_amount = cfg.train.jitter if training else 0.0
    bg = (bg_ray_colors.to(f32) if bg_ray_colors is not None
          else torch.as_tensor(cfg.bg_color, dtype=f32,
                               device=dev).expand(R, 3))

    u_full = jitter_u
    if u_full is None and jit_amount > 0.0 and generator is not None:
        u_full = jitter_uniform((R, D), generator)

    def probe_output(color, mask=None, rows=M):
        return TrainRenderOutput(
            coarse_raycolor=color.expand(R, 3),
            ray_mask=(torch.zeros(R, dtype=torch.bool, device=dev)
                      if mask is None else mask),
            acc=torch.zeros(R, dtype=f32, device=dev),
            depth=torch.zeros(R, dtype=f32, device=dev),
            conf_coefficient=torch.zeros((rows, K), dtype=f32, device=dev),
            pnt_mask=torch.zeros((rows, K), dtype=torch.bool, device=dev),
            weight=torch.zeros((rows, K), dtype=f32, device=dev))

    if q.ray_budget > 0:
        # ---- ray packing: only box-hitting rays enter the front-end. A
        # miss ray renders exact background (a constant: no gradient) and
        # takes no slots, so packing the first RB hitting rays and putting
        # their outputs back is exact, forward and gradients, while
        # rb_overflow == 0. Jitter is drawn on the full ray set and
        # gathered, so the packed rays see the unpacked path's draws.
        ray_ids, valid, rb_overflow = pack_hit_rays(
            geo, campos, raydirs, near, far, q, ranges_min, scaled_vsize,
            jitter=jit_amount)
        if debug_prefix == "draw":
            z = (torch.zeros((), dtype=f32, device=dev) if u_full is None
                 else u_full.sum())
            return probe_output(
                z * 1e-6 + ray_ids.to(f32).sum() * 1e-9,
                valid if valid.shape[0] >= R else None, rows=1)
        cfg0 = dataclasses.replace(cfg, query=dataclasses.replace(
            q, ray_budget=0))
        sub = fast_train_render(
            params, points, geo, campos, camrotc2w, raydirs[ray_ids], near,
            far, cfg0, ranges_min, scaled_vsize, training=training,
            jitter_u=None if u_full is None else u_full[ray_ids],
            ray_live=valid, debug_prefix=debug_prefix,
            bg_ray_colors=(None if bg_ray_colors is None
                           else bg_ray_colors[ray_ids]),
            points_axis=points_axis)
        ids = torch.where(valid, ray_ids, R)       # padding rows drop

        def scatter(base, x):
            out = torch.cat([base, base[:1]])
            out[ids] = x.to(base.dtype)
            return out[:R]

        return TrainRenderOutput(
            coarse_raycolor=scatter(bg, sub.coarse_raycolor),
            ray_mask=scatter(torch.zeros(R, dtype=torch.bool, device=dev),
                             sub.ray_mask),
            acc=scatter(torch.zeros(R, dtype=f32, device=dev), sub.acc),
            depth=scatter(torch.zeros(R, dtype=f32, device=dev), sub.depth),
            conf_coefficient=sub.conf_coefficient, pnt_mask=sub.pnt_mask,
            weight=sub.weight, rb_overflow=rb_overflow,
            mc_overflow=sub.mc_overflow)

    raygen = (near_far_disparity_linear_ray_generation if cfg.inverse
              else near_far_linear_ray_generation)
    raypos, _, mid_ts = raygen(campos, raydirs, D, near, far,
                               jitter=jit_amount, jitter_u=u_full)
    mid_ts = mid_ts.contiguous()
    if debug_prefix == "mid":
        return probe_output(mid_ts.sum() * 1e-6)
    if debug_prefix == "raygen":
        return probe_output(raypos.sum((0, 1)) + mid_ts.sum() * 1e-6)

    mc_overflow = None
    if march_active(q) and not cfg.inverse and geo.hash_table is None:
        # ---- the jitter-aware distance-field march (ops/march.py): it
        # tests each sample's true jittered position through the mid_ts
        # table, so it emits the dense path's first-cap valid samples
        # without the [R, D] lookup. Exact while mc_overflow == 0. A hash
        # grid has no march table: its samples take the lookup below, as
        # in the reference.
        if geo.march_table is None:
            raise ValueError("march_steps needs a geo cache with "
                             "march_table (make_geo_scene builds it)")
        if geo.meta.shape[0] > (1 << 22) - 2 or D > 512:
            raise ValueError("march packing needs max_q < 2^22 - 1 and "
                             "z_depth_dim <= 512")
        dims = geo.coor_2_qslot.shape
        cap = min(SR, BP, D)
        emit, cnt, mc_overflow = march_rays(
            geo.march_table.reshape(-1),
            torch.tensor(dims, dtype=torch.int32, device=dev), dims[1],
            dims[2], ranges_min, scaled_vsize, campos, raydirs.contiguous(),
            near, far, (far - near) / D, D, cap, q.march_steps,
            q.march_buckets, t_tab=mid_ts, jitter=jit_amount, live=ray_live)
        ray_hit = cnt > 0
        iota = torch.arange(cap, dtype=torch.int32, device=dev).expand(R, cap)
        sel_ray, sel_slot, _, _, packed_m, mask_c = rank_gather_pack(
            emit, iota, cnt, M)
        qslot_c = torch.clamp((packed_m >> 9) - 1, min=0)
        sel_d = packed_m & 511
    else:
        # ---- the dense front-end: every sample's qslot (the dense table
        # or the hash table), then the first min(SR, BP) valid columns per
        # ray packed to M slots (the column selection, or under
        # compact_mode="onehot" the one-hot compaction)
        qs = qslot_lookup(geo, raypos, ranges_min,
                          scaled_vsize).to(torch.int32)
        if ray_live is not None:
            # the packing's padding rows repeat ray 0: they take no slots,
            # as the march's walk skips them (the reference lets them, so
            # its per-slot loss terms count ray 0's samples again)
            qs = torch.where(ray_live[:, None], qs, -1)
        qs = qs.contiguous()
        if q.compact_mode == "topk":
            col_sel, cnt, ray_hit = select_first_cols(qs, BP, min(SR, BP),
                                                      q.select_mode)
            sel_ray, sel_slot, sel_d, _, qslot_c, mask_c = rank_gather_pack(
                qs, col_sel, cnt, M)
        else:
            ray_hit = (qs >= 0).any(-1)
            sel_ray, sel_slot, sel_d, qslot_c, mask_c, cnt = onehot_compact(
                qs, torch.arange(D, dtype=torch.int32, device=dev).expand(
                    R, D), min(SR, BP), BP, M)
    del raypos
    if debug_prefix == "front":
        return probe_output(torch.stack([
            qslot_c.to(f32).sum() * 1e-6, sel_ray.to(f32).sum() * 1e-6,
            mask_c.to(f32).sum() * 1e-6]), mask=ray_hit)

    t_flat = mid_ts.reshape(R * D)
    sel_rd = torch.clamp(sel_ray * D + sel_d, max=R * D - 1)
    attrs = torch.cat([points.points_embeding, points.points_conf,
                       points.points_dir, points.points_color], -1)

    # ---- chunks of CH slots (the reference's lax.map), every one computed
    CH = max(min(q.fast_chunk or 8192, M), min(2048, M))
    n = -(-M // CH)
    pad = n * CH - M

    def cpad(x):
        return torch.cat([x, x.new_zeros(pad)]) if pad else x

    ins = [cpad(x) for x in (qslot_c, sel_ray, sel_rd, mask_c)]
    body_args = (params, cfg, points, attrs, points_axis, geo, campos,
                 camrotc2w, raydirs, t_flat, ranges_min, scaled_vsize,
                 training)
    full = training and cfg.train.remat == "full"
    outs = []
    for i in range(n):
        rows = tuple(x[i * CH:(i + 1) * CH] for x in ins)
        if full:
            outs.append(checkpoint(_chunk_body, *body_args, *rows,
                                   debug_prefix, use_reentrant=False))
        else:
            outs.append(_chunk_body(*body_args, *rows, debug_prefix))
    sig, rgb, found, conf_k, pm_k, w_k = (torch.cat(x)[:M]
                                          for x in zip(*outs))
    if debug_prefix == "decode":
        return probe_output(torch.stack([
            sig.sum() * 1e-6, rgb.sum() * 1e-6, found.to(f32).sum() * 1e-6]),
            mask=ray_hit)

    slot_ok = mask_c & found
    sig = sig * slot_ok.to(sig.dtype)
    z_sel = w2pers(campos + raydirs[sel_ray] * t_flat[sel_rd][:, None],
                   camrotc2w, campos)[..., 2]
    out = dict(conf_coefficient=conf_k, pnt_mask=pm_k & mask_c[:, None],
               weight=w_k, mc_overflow=mc_overflow)
    if q.composite_mode == "packed" and q.compact_mode == "topk":
        # ---- packed composite
        rgb_sum, acc, depth, ray_found = packed_alpha_composite(
            sig, rgb, z_sel, slot_ok, sel_ray, torch.cumsum(cnt.long(), 0),
            cnt, q.vsize[2], cfg.blend_func, max_slots=BP)
    else:
        # ---- the grid composite: the slots scatter to [R, BP] rows (a
        # differentiable put whose targets never collide), then alpha
        # compositing per row
        dest = torch.where(slot_ok, sel_ray * BP + sel_slot, R * BP)

        def grid(x):
            g = x.new_zeros((R * BP + 1,) + x.shape[1:])
            return g.index_put((dest,), x)[:R * BP].reshape(
                (R, BP) + x.shape[1:])

        valid_rb = grid(slot_ok)
        rgb_sum, acc, depth, _ = composite_rows(
            grid(sig), grid(rgb), grid(z_sel), valid_rb, q.vsize[2],
            cfg.blend_func)
        ray_found = valid_rb.any(-1)
    color = rgb_sum + (1 - acc)[..., None] * bg
    color = TONE_MAPS[cfg.tonemap_func](color)
    ray_mask = ray_hit & ray_found
    color = torch.where(ray_mask[:, None], color, bg)
    return TrainRenderOutput(coarse_raycolor=color, ray_mask=ray_mask,
                             acc=acc, depth=depth, **out)


def make_fast_train_step(cfg: PointNerfConfig):
    """A train step through the fast differentiable path:

        step(state, geo, ranges_min, scaled_vsize, campos, camrotc2w,
             raydirs, gt_rgb, near, far, generator=None, jitter_u=None,
             gt_mask=None, bg_rgb=None) -> (state, aux)

    `state` (train/trainer.TrainState) is updated in place and returned;
    `aux` holds the loss parts, `rb_overflow` and `mc_overflow` (where the
    config has them) as device scalars, nothing read back to the host.
    Both optimizer groups step every iteration, or in turns under
    TrainConfig.alter_step (train/trainer.apply_updates). Its spans and
    counter are the legacy step's (train/trainer.make_train_step)."""
    from pointnerf2studio_torch.train.loss import compute_losses
    from pointnerf2studio_torch.train.trainer import apply_updates

    def train_step(state, geo, ranges_min, scaled_vsize, campos, camrotc2w,
                   raydirs, gt_rgb, near, far,
                   generator: Optional[torch.Generator] = None,
                   jitter_u: Optional[torch.Tensor] = None,
                   gt_mask: Optional[torch.Tensor] = None,
                   bg_rgb: Optional[torch.Tensor] = None
                   ) -> Tuple[object, Dict[str, torch.Tensor]]:
        profiling.count("train.steps")
        with profiling.span("train.step", f"step={state.step}"):
            state.zero_grad()
            with profiling.span("train.forward"):
                out = fast_train_render(
                    state.params, state.points, geo, campos, camrotc2w,
                    raydirs, near, far, cfg, ranges_min, scaled_vsize,
                    generator=generator, training=True, jitter_u=jitter_u,
                    bg_ray_colors=bg_rgb)
            with profiling.span("train.loss"):
                total, aux = compute_losses(out, gt_rgb, cfg.train,
                                            gt_mask=gt_mask)
            with profiling.span("train.backward"):
                total.backward()
            aux = {k: v.detach() for k, v in aux.items()}
            for name in ("rb_overflow", "mc_overflow"):
                v = getattr(out, name)
                if v is not None:
                    aux[name] = v.to(torch.float32)
            with profiling.span("train.optimizer"):
                apply_updates(state, cfg)
            return state, aux

    return train_step
