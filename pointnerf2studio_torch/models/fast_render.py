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

Not ported yet: the "rows" cache layout and the XLA candidate stages,
span tiers, coarse windows, the march and raster front-ends, prob mode,
hash grids and sharding; a config that asks for them raises.

No host synchronisation happens per chunk: ray packing and slot packing
are cumsum/scatter compactions on the device, and the kernels skip
masked slots themselves.
"""

from __future__ import annotations

import dataclasses
import math
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
from pointnerf2studio_torch.ops.query import neighbor_offsets
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
    """
    coor_2_qslot: torch.Tensor     # [gx, gy, gz] int32, -1 = not query
    kmeta: torch.Tensor            # [max_q, C] int32
    kcand: torch.Tensor            # [max_q, C, PK] bf16
    kxyz: torch.Tensor             # [max_q, 3, C] bf16
    n_q: torch.Tensor              # [] int32

    @property
    def cand(self) -> int:
        return self.kmeta.shape[1]

    @property
    def kpay(self) -> torch.Tensor:
        return self.kcand.transpose(1, 2)


@torch.no_grad()
def build_fat_cache(grid: PointGrid, cloud: NeuralPointCloud,
                    kernel_size: Tuple[int, int, int], max_q: int,
                    cand_cap: int = 64, chunk: int = 32768) -> FatCache:
    """Build the candidate cache for the kernels (the content of the
    reference's layout="fused", stored candidate-major: see `FatCache`;
    the "rows" layout is not ported), once per point/attribute change.

    Candidate order is the reference's f32 key shell * 1e12 + min(d2,
    1e9), sorted stably: beyond shell 0 the d2 term is below one ulp of
    the shell term, so outer-shell candidates keep their scan order."""
    dev = cloud.xyz.device
    offs_np, shells_np = neighbor_offsets(kernel_size)
    offsets = torch.as_tensor(offs_np, dtype=torch.long, device=dev)
    shells = torch.as_tensor(shells_np, dtype=torch.long, device=dev)
    V = offsets.shape[0]
    P = grid.occ_2_pnts.shape[1]
    C = min(cand_cap, V * P)
    gx, gy, gz = grid.dims
    nvox = gx * gy * gz
    dims_t = torch.tensor(grid.dims, device=dev)
    xyz = cloud.xyz
    N = xyz.shape[0]

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
    q_live = q_flat < nvox
    # one rounding of rmin + (q + 0.5) * svs, as the reference's compiled
    # build gets from a fused multiply-add; the bf16 relative xyz below
    # inherits this value bit for bit
    center_w = (grid.ranges_min.double() + (q_coor.double() + 0.5)
                * grid.scaled_vsize.double()).float()

    attrs = torch.cat([cloud.points_embeding, cloud.points_conf,
                       cloud.points_dir, cloud.points_color],
                      -1).to(torch.bfloat16)                    # [N, 39]
    c2o = grid.coor_2_occ.reshape(-1)
    kmeta = torch.empty((max_q, C), dtype=torch.int32, device=dev)
    kcand = torch.empty((max_q, C, PK), dtype=torch.bfloat16, device=dev)
    kxyz = torch.empty((max_q, 3, C), dtype=torch.bfloat16, device=dev)
    for s in range(0, max_q, chunk):
        qc, cw, live = q_coor[s:s + chunk], center_w[s:s + chunk], \
            q_live[s:s + chunk]
        B = qc.shape[0]
        nb = qc[:, None, :] + offsets[None]                     # [B, V, 3]
        inb = ((nb >= 0) & (nb < dims_t)).all(-1) & live[:, None]
        nbc = torch.minimum(torch.clamp(nb, min=0), dims_t - 1)
        slot = c2o[(nbc[..., 0] * gy + nbc[..., 1]) * gz + nbc[..., 2]]
        slot_ok = inb & (slot >= 0)
        cand = grid.occ_2_pnts[torch.where(slot_ok, slot, 0).long()]
        ok = slot_ok[..., None] & (cand >= 0)                   # [B, V, P]
        cxyz = xyz[torch.clamp(cand, 0, N - 1).long()]          # [B,V,P,3]
        dd = cxyz - cw[:, None, None, :]
        d2c = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] \
            + dd[..., 2] * dd[..., 2]
        okf = ok.reshape(B, V * P)
        sh = shells[None, :, None].expand(B, V, P).reshape(B, V * P)
        key = sh.float() * 1e12 + torch.clamp(d2c.reshape(B, V * P), max=1e9)
        key = torch.where(okf, key, float("inf"))
        top = torch.sort(key, dim=-1, stable=True).indices[:, :C]
        sel_ok = torch.gather(okf, 1, top)
        sel_pidx = torch.gather(cand.reshape(B, V * P).long(), 1, top)
        sel_sh = torch.gather(sh, 1, top)
        sel_xyz = torch.gather(cxyz.reshape(B, V * P, 3), 1,
                               top[..., None].expand(B, C, 3))
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
                 device: torch.device | str | None = None) -> int:
    """Halve cand_cap (floor 8) until max_q * cand_cap * ROWW * 4 bytes
    (the reference's sizing) fit the budget: 60% of the CUDA device's
    memory (torch.cuda.mem_get_info), or of 16 GiB for other devices."""
    if budget_bytes is None:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            budget_bytes = int(torch.cuda.mem_get_info(dev)[1] * 0.6)
        else:
            budget_bytes = int((16 << 30) * 0.6)
    cc = cand_cap
    while cc > 8 and max_q * cc * ROWW * 4 > budget_bytes:
        cc //= 2
    if max_q * cc * ROWW * 4 > budget_bytes:
        raise ValueError(
            f"fat cache infeasible: {max_q} query voxels x cand_cap {cc} x "
            f"{ROWW * 4} B = {max_q * cc * ROWW * 4 / 2 ** 30:.1f}"
            f" GiB exceeds the {budget_bytes / 2 ** 30:.1f} GiB budget "
            f"even at the minimum candidate width; coarsen vsize")
    if cc != cand_cap:
        print(f"fat cache: cand_cap {cand_cap} -> {cc} to fit {max_q} query "
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
    # valid compacted sample slots (the rows the tower shades)
    n_valid_slots: Optional[torch.Tensor] = None


def _slab(raydirs, campos, ranges_min, rmax):
    """Entry/exit t of each ray through the grid bounding box."""
    tiny = torch.full_like(raydirs, 1e-9)
    safe = torch.where(torch.abs(raydirs) < 1e-9,
                       torch.where(raydirs >= 0, tiny, -tiny), raydirs)
    inv = 1.0 / safe
    ta = (ranges_min - campos) * inv
    tb = (rmax - campos) * inv
    t_enter = torch.minimum(ta, tb).max(-1).values
    t_exit = torch.maximum(ta, tb).min(-1).values
    return t_enter, t_exit


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
        "span_tiers": bool(q.span_tiers), "march_steps": bool(q.march_steps),
        "coarse_step": q.coarse_step > 1,
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
            f"port serves depth_window/ray_budget + topk compaction + "
            f"packed composite with chunk_mode='fused' (an eligible "
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
    weight = aggregation_weight(cfg.agg, dists, pnt_mask)
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
) -> FastRenderOutput:
    """Render R rays through the fast path (see the module docstring)."""
    route = _check_served(cfg, Rw2c)
    q = cfg.query
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    D = q.z_depth_dim
    SR, K = q.SR, q.K
    BP = q.ray_slot_budget or min(SR, 32)
    budget = q.compact_budget if q.compact_budget > 0 else SR
    M = min(R * budget, R * D)
    dims = cache.coor_2_qslot.shape
    gy, gz = dims[1], dims[2]
    dims_t = torch.tensor(dims, device=dev)
    dims_f = dims_t.to(f32)
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
        RB = min(q.ray_budget, R)
        t_enter, t_exit = _slab(raydirs, campos, ranges_min, rmax)
        hit = ((t_exit + step_t >= t_enter) & (t_exit >= near - step_t)
               & (t_enter <= far + step_t))
        pos = torch.cumsum(hit.long(), 0) - 1
        dest = torch.where(hit & (pos < RB), pos, RB)
        ray_ids = torch.zeros(RB + 1, dtype=torch.long, device=dev).scatter_(
            0, dest, torch.arange(R, device=dev))[:RB]
        n_hit = hit.sum()
        valid = torch.arange(RB, device=dev) < n_hit
        rb_overflow = torch.clamp(n_hit - RB, min=0).to(torch.int32)
        cfg0 = dataclasses.replace(cfg, query=dataclasses.replace(
            q, ray_budget=0))
        sub = fast_render_rays(params, Rw2c, cache, campos, camrotc2w,
                               raydirs[ray_ids], near, far, cfg0,
                               ranges_min, scaled_vsize)
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
            cb_overflow=sub.cb_overflow, n_valid_slots=sub.n_valid_slots)

    qslot_flat = cache.coor_2_qslot.reshape(-1)

    def qs_lookup(pos):
        gc = torch.floor((pos - ranges_min) / scaled_vsize).to(torch.int32)
        inb = ((gc >= 0) & (gc < dims_t)).all(-1)
        gcc = torch.minimum(torch.clamp(gc, min=0), dims_t - 1).long()
        fi = (gcc[..., 0] * gy + gcc[..., 1]) * gz + gcc[..., 2]
        return torch.where(inb, qslot_flat[torch.where(inb, fi, 0)], -1)

    if q.depth_window > 0:
        # ---- per-ray depth window: the lookup domain is [R, DW]
        # samples from the ray's slab entry; exact while DW covers each
        # ray's in-box span (dw_overflow counts the dropped samples)
        DW = min(q.depth_window, D)
        t_enter, t_exit = _slab(raydirs, campos, ranges_min, rmax)
        d_lo = torch.floor((t_enter - near) / step_t - 0.5).to(torch.int32)
        d0 = torch.clamp(d_lo, 0, max(D - DW, 0))
        d_hi = torch.clamp(torch.ceil(
            (torch.minimum(t_exit, far) - near) / step_t - 0.5
        ).to(torch.int32), max=D - 1)
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
        dw_overflow = None
        Dax = D
    qs = qs.to(torch.int32).contiguous()

    # ---- first min(SR, BP) valid columns per ray, packed to M slots
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
        n_valid_slots=mask_c.sum().to(torch.int32))


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
