"""The legacy end-to-end render step.

Port of `pointnerf2studio_tpu/models/render.py::render_rays` (all of it
but the row-sharded gather, `points_axis`): stratified ray generation ->
voxel-grid ray masking -> shading-slot compaction -> K-NN -> neighbour
gather -> weights and the MLP tower -> alpha compositing over the [R, D]
sample grid -> background fill.

The K-NN runs on the grid's candidate cache where the grid carries one
(`ops/grid.build_grid_from_points` with `QueryConfig.use_cache`, the
reference's default: `mask_raypos_qslot` + `knn_from_cache`), else on the
grid itself (`mask_raypos` + `knn_for_locs`). With `training` the
samples are jittered (cfg.train.jitter; draws from `jitter_u` [R, D] or
`generator`), the neighbours' confidence passes `conf_gradient_clamp`,
and gradients flow into the tower and the cloud's trainable attributes;
`prob` adds the point-growing outputs; `bg_ray_colors` [R, 3] replaces
the constant background in the blend and the miss fill; a per-point Rw2c
[N, 3, 3] rotates each neighbour's offsets and directions. Serving runs
under `torch.no_grad()` at the call site.

The tower is the row-wise decode kernel (ops/fused_decode.py::
fused_decode) where `AggregatorConfig.fused_decode` is set, `training`
is not, and `fused_decode_served` holds (the reference also wants a TPU
backend; the port has no such test), else `decode_radiance`; both run
in pieces of `QueryConfig.decode_chunk` slots.

Compaction. The reference picks each ray's first SR valid samples with
an [R, D, SR] one-hot contraction that XLA fuses; materialised it would
be R * D * SR elements. The same selection - the first SR valid samples
per ray, packed ray-major and valid-first into M slots - is
`first_valid_cols` on the [R, D] qslot table (the CUDA kernel on the
card) followed by `rank_gather_pack`. Padded slots are dropped from the
scatters back to [R, D] (the reference writes them onto sample 0 of
ray 0, beside that sample's own value).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import (
    Aggregator, aggregation_weight, conf_gradient_clamp, decode_radiance)
from pointnerf2studio_torch.models.neural_points import (
    NeuralPointCloud, gather_neighbors)
from pointnerf2studio_torch.ops.camera import neighbor_dists, rotate, w2pers
from pointnerf2studio_torch.ops.compositing import (
    BLEND_FUNCTIONS, TONE_MAPS, ray_dist_from_sample_z)
from pointnerf2studio_torch.ops.fused_decode import (
    fused_decode, fused_decode_served, tower_inputs)
from pointnerf2studio_torch.ops.grid import PointGrid
from pointnerf2studio_torch.ops.query import (
    knn_for_locs, knn_from_cache, mask_raypos, mask_raypos_qslot)
from pointnerf2studio_torch.ops.raygen import (
    jitter_uniform, near_far_disparity_linear_ray_generation,
    near_far_linear_ray_generation)
from pointnerf2studio_torch.ops.select import (
    first_valid_cols, rank_gather_pack)


@dataclasses.dataclass
class RenderOutput:
    coarse_raycolor: torch.Tensor       # [R, 3] final colour (bg-filled)
    ray_mask: torch.Tensor              # [R] bool
    acc: torch.Tensor                   # [R] accumulated opacity
    depth: torch.Tensor                 # [R] expected termination depth
    conf_coefficient: torch.Tensor      # [M, K] neighbour confidences
    pnt_mask: torch.Tensor              # [M, K] neighbour validity
    weight: Optional[torch.Tensor] = None   # [M, K] aggregation weights
    # prob=True: each ray's sample of largest opacity and the neighbours'
    # weight * conf averages there (point growing)
    ray_max_shading_opacity: Optional[torch.Tensor] = None   # [R]
    ray_max_sample_loc_w: Optional[torch.Tensor] = None      # [R, 3]
    shading_avg_color: Optional[torch.Tensor] = None         # [R, 3]
    shading_avg_dir: Optional[torch.Tensor] = None           # [R, 3]
    shading_avg_conf: Optional[torch.Tensor] = None          # [R, 1]
    shading_avg_embedding: Optional[torch.Tensor] = None     # [R, C]


def compact_samples(qs: torch.Tensor, SR: int, M: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first SR valid samples of each ray (qs [R, D] int32, >= 0
    marks a valid sample), packed ray-major and valid-first into M slots:
    (sel [M] int64 flat ray * D + d, 0 on the padded slots as in the
    reference; mask_c [M] bool; ray_id [M])."""
    R, D = qs.shape
    col_sel, cnt_raw = first_valid_cols(qs.contiguous(), SR)
    cnt = torch.clamp(cnt_raw, max=SR)
    _, _, _, sel, _, mask_c = rank_gather_pack(qs, col_sel, cnt, M)
    sel = torch.where(mask_c, sel, 0)
    return sel, mask_c, sel // D


def render_rays(
    params: Aggregator,
    points: NeuralPointCloud,
    grid: PointGrid,
    campos: torch.Tensor,       # [3]
    camrotc2w: torch.Tensor,    # [3, 3]
    raydirs: torch.Tensor,      # [R, 3] normalised world directions
    near, far,
    cfg: PointNerfConfig,
    training: bool = False,
    prob: bool = False,
    bg_ray_colors: Optional[torch.Tensor] = None,   # [R, 3]
    generator: Optional[torch.Generator] = None,
    jitter_u: Optional[torch.Tensor] = None,        # [R, D] jitter draws
) -> RenderOutput:
    """Render R rays through the legacy path (see the module docstring).
    Differentiable in `params` and the cloud's trainable attributes."""
    q = cfg.query
    dev = raydirs.device
    f32 = torch.float32
    R = raydirs.shape[0]
    SR, D, K = q.SR, q.z_depth_dim, q.K
    raygen = (near_far_disparity_linear_ray_generation if cfg.inverse
              else near_far_linear_ray_generation)
    jitter = cfg.train.jitter if training else 0.0
    if jitter > 0.0 and jitter_u is None and generator is not None:
        jitter_u = jitter_uniform((R, D), generator)
    raypos, _, _ = raygen(campos, raydirs, D, near, far, jitter=jitter,
                          jitter_u=jitter_u)

    # Stage 1: ray masking; the per-ray first-SR cap comes with stage 2
    use_cache = grid.cache is not None
    if use_cache:
        qs = mask_raypos_qslot(grid, raypos)                  # [R, D] int32
    else:
        qs = mask_raypos(grid, raypos).to(torch.int32) - 1
    ray_hit = (qs >= 0).any(-1)

    # Stage 2: validity compaction across (ray, sample) pairs
    budget = q.compact_budget if q.compact_budget > 0 else SR
    M = min(R * budget, R * D)
    sel, mask_c, ray_id = compact_samples(qs, SR, M)
    locs = raypos.reshape(R * D, 3)[sel]                      # [M, 3]

    # Stage 3: K-NN + gathers on the compacted set only
    if use_cache:
        pidx = knn_from_cache(grid, qs.reshape(R * D)[sel], locs, mask_c, K,
                              q.radius_limit ** 2,
                              (q.kernel_size[0] + 1) // 2,
                              layered=q.layered_search)       # [M, K]
    else:
        pidx = knn_for_locs(grid, points.xyz, locs, mask_c, K,
                            q.radius_limit ** 2, q.kernel_size,
                            layered=q.layered_search)         # [M, K]
    pnt_mask = pidx >= 0
    neigh = gather_neighbors(points, pidx)
    dists = neighbor_dists(neigh["xyz"], locs, camrotc2w, campos)

    weight, emb = aggregation_weight(cfg.agg, neigh["embeding"], dists,
                                     pnt_mask, max(q.scaled_vsize), params)
    conf = neigh["conf"][..., 0]
    if training:
        conf = conf_gradient_clamp(conf)
    if cfg.agg.conf_in_weight:
        weight = weight * conf

    per_point = points.Rw2c.ndim == 3
    if per_point:            # the rotation happens per neighbour
        rw2c, vd_sel = neigh["Rw2c"], raydirs[ray_id]
    else:
        rw2c, vd_sel = points.Rw2c, rotate(raydirs, points.Rw2c)[ray_id]
    # raises for an eligible config whose kernel the port lacks
    use_fused = (cfg.agg.fused_decode and not training
                 and fused_decode_served(cfg.agg, per_point, K))

    DC = q.decode_chunk if q.decode_chunk and M > q.decode_chunk else max(M, 1)
    pieces = [slice(s, s + DC) for s in range(0, M, DC)]
    if use_fused:
        dists_rot, dirdot, wk, dir_pe = tower_inputs(
            cfg.agg, dists, neigh["dir"], vd_sel, weight, pnt_mask, rw2c)
        outs = [fused_decode(params, emb[s], dists_rot[s], neigh["color"][s],
                             dirdot[s], wk[s], dir_pe[s],
                             cfg.agg.num_feat_freqs, cfg.agg.num_dist_freqs)
                for s in pieces]
    else:
        outs = [decode_radiance(
            params, cfg.agg, neigh_emb=emb[s], neigh_color=neigh["color"][s],
            neigh_dir=neigh["dir"][s], dists=dists[s], weight=weight[s],
            pnt_mask=pnt_mask[s], viewdirs=vd_sel[s],
            Rw2c=rw2c[s] if per_point else rw2c)
            for s in pieces]
    if outs:
        sigma_c, rgb_c = (torch.cat(x) for x in zip(*outs))
    else:
        sigma_c = torch.zeros(0, dtype=f32, device=dev)
        rgb_c = torch.zeros((0, 3), dtype=f32, device=dev)

    # Stage 4: scatter the compacted results back to [R, D] sample slots;
    # padded slots go to a sentinel row that is sliced off
    slot_ok = mask_c & pnt_mask.any(-1)                       # [M]
    sigma_c = sigma_c * slot_ok.to(sigma_c.dtype)
    dest = torch.where(mask_c, sel, R * D)

    def scatter(x, fill=0):
        out = torch.full((R * D + 1,) + x.shape[1:], fill, dtype=x.dtype,
                         device=dev)
        out[dest] = x
        return out[:R * D].reshape((R, D) + x.shape[1:])

    sigma = scatter(sigma_c)
    rgb = scatter(rgb_c)
    slot_valid = scatter(slot_ok)

    # Compositing over the full [R, D] grid: invalid samples' z is masked
    # far back so that step lengths span consecutive valid samples
    loc_pers_z = w2pers(raypos, camrotc2w, campos)[..., 2]
    z_masked = torch.where(slot_valid, loc_pers_z,
                           torch.full_like(loc_pers_z, -1e9))
    dist = ray_dist_from_sample_z(z_masked, slot_valid, q.vsize[2])
    opacity = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(1.0 - opacity + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    blend = BLEND_FUNCTIONS[cfg.blend_func](opacity, trans)   # [R, D]
    # a per-ray background replaces the constant one in the blend and in
    # the miss fill alike
    bg = (bg_ray_colors if bg_ray_colors is not None
          else torch.as_tensor(cfg.bg_color, dtype=f32, device=dev))
    acc = blend.sum(-1)
    color = (blend[..., None] * rgb).sum(-2) + (1 - acc)[..., None] * bg
    color = TONE_MAPS[cfg.tonemap_func](color)
    depth = (blend * loc_pers_z).sum(-1)

    # rays whose shading points found no neighbours fall out of the mask
    ray_mask = ray_hit & slot_valid.any(-1)
    color = torch.where(ray_mask[..., None], color, bg)

    prob_out = {}
    if prob:
        # each ray's sample of largest opacity (the first among equals)
        # and the weight * conf averages of its slot's neighbours
        s_star = torch.argmax(opacity, -1)                    # [R]
        flat_star = torch.arange(R, device=dev) * D + s_star
        slot_to_m = scatter(torch.arange(M, device=dev), fill=-1).reshape(-1)
        m_idx = slot_to_m[flat_star]                          # [R]
        mi = torch.clamp(m_idx, min=0)
        wc = ((weight[mi] * conf[mi])[..., None]
              * (m_idx >= 0)[:, None, None])                  # [R, K, 1]
        prob_out = {
            "ray_max_shading_opacity": torch.gather(
                opacity, 1, s_star[:, None])[:, 0],
            "ray_max_sample_loc_w": raypos.reshape(R * D, 3)[flat_star],
            "shading_avg_color": (neigh["color"][mi] * wc).sum(-2),
            "shading_avg_dir": (neigh["dir"][mi] * wc).sum(-2),
            "shading_avg_conf": (neigh["conf"][mi] * wc).sum(-2),
            "shading_avg_embedding": (neigh["embeding"][mi] * wc).sum(-2),
        }
    return RenderOutput(
        coarse_raycolor=color, ray_mask=ray_mask, acc=acc, depth=depth,
        conf_coefficient=conf, pnt_mask=pnt_mask & mask_c[..., None],
        weight=weight, **prob_out)
