"""Radiance decoder: the per-neighbour MLP tower and K-aggregation.

Port of `pointnerf2studio_tpu/models/aggregator.py`: aggregation orders
0, 1 and 2, all nine aggregation weight kernels (`raw_aggregation_weight`:
linear, numlinear, quadric, numquadric, avg, trilinear, sh_intrp,
gau_intrp, feat_intrp, with the learned `feat_weight_mlp` tower of the
last) and their three normalisations, a global or a per-point Rw2c,
float32 or bfloat16 compute.

Tower (all LeakyReLU(0.1), including output activations):
  mlp_base:  [emb(32), PE_3(emb)(192), PE_5(dists@Rw2c)(60)] -> 2x256
  mlp_head:  [base(256), colour(3), dir-viewdir(3), dot(1)] -> 2x256
  density:   Linear(256 -> 1) + ReLU (softplus(x - 1) under act_super)
  mlp_color: [sum_K(w * head)(256), PE_4(viewdir)(24)] -> 3x128
  rgb:       Linear(128 -> 3) + sigmoid, squashed *1.002 - 0.001

Weights live in `Aggregator`, an nn.Module whose towers are ModuleLists
of nn.Linear (weight [out, in]; the JAX tree keeps kernels [in, out],
see convert.py). An Aggregator is built with its gradients off, as the
render paths use it (they run under `torch.no_grad`); the train state
(train/trainer.py) holds a copy with them on, and `decode_radiance`,
`aggregation_weight` and `conf_gradient_clamp` are differentiable.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.camera import world2local_dist
from pointnerf2studio_torch.ops.encoding import positional_encoding
from pointnerf2studio_torch.utils.spherical import sh_basis

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the towers of every config; feat_intrp adds "feat_weight_mlp"
TOWERS = ("mlp_base", "mlp_head", "mlp_color", "density_head", "color_head")


def _mlp_dims(cfg: AggregatorConfig) -> Dict[str, List[Tuple[int, int]]]:
    """(in, out) per layer of each tower, as the JAX reference sizes them."""
    dist_dim = cfg.dist_dim
    dist_pe = (2 * cfg.num_dist_freqs * dist_dim if cfg.num_dist_freqs
               else dist_dim)
    feat_dim = cfg.shading_feature_dim
    if cfg.agg_intrp_order == 0:
        dist_pe = 0
    base_in = 2 * cfg.num_feat_freqs * feat_dim + dist_pe + feat_dim
    head_in = (cfg.hidden_size + (3 if cfg.point_color_mode else 0)
               + (4 if cfg.point_dir_mode else 0))
    color_in = cfg.hidden_size + 2 * cfg.num_viewdir_freqs * 3

    def tower(in_dim, width, n):
        return [(in_dim, width)] + [(width, width)] * (n - 1)

    dims = {
        "mlp_base": tower(base_in, cfg.hidden_size, cfg.num_mlp_base_layers),
        "mlp_head": tower(head_in, cfg.hidden_size, cfg.num_mlp_head_layers),
        "mlp_color": tower(color_in, cfg.hidden_size_color,
                           cfg.num_color_layers),
        "density_head": [(cfg.hidden_size, 1)],
        "color_head": [(cfg.hidden_size_color, 3)],
    }
    if cfg.agg_distance_kernel == "feat_intrp":
        # the learned weight: two halving layers and a scalar head
        w_in = 2 * cfg.weight_xyz_freq * 3 + cfg.weight_feat_dim
        half = w_in // 2
        dims["feat_weight_mlp"] = [(w_in, half), (half, half), (half, 1)]
    return dims


class Aggregator(nn.Module):
    """The decoder's weights: one ModuleList of nn.Linear per tower, on
    `device` (None: the card; raises without one). `towers` names them:
    TOWERS, and "feat_weight_mlp" under the feat_intrp weight kernel."""

    def __init__(self, cfg: AggregatorConfig, seed: int = 0,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.towers = tuple(_mlp_dims(cfg))
        for t, (name, dims) in enumerate(_mlp_dims(cfg).items()):
            # torch nn.Linear's default distribution, U(+-1/sqrt(in)),
            # drawn from a generator seeded per tower so the weights
            # depend on (seed, tower) alone
            gen = torch.Generator().manual_seed(seed * 1009 + t)
            layers = []
            for i, o in dims:
                lin = nn.utils.skip_init(nn.Linear, i, o)
                bound = 1.0 / i ** 0.5
                with torch.no_grad():
                    lin.weight.copy_(
                        (torch.rand(o, i, generator=gen) * 2 - 1) * bound)
                    lin.bias.copy_(
                        (torch.rand(o, generator=gen) * 2 - 1) * bound)
                layers.append(lin)
            setattr(self, name, nn.ModuleList(layers).to(device))
        # the render paths' default; create_train_state turns a copy's on
        self.requires_grad_(False)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _linear_head(lyr: nn.Linear, x: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """x @ W + b with operands, product and sum each in `dtype`."""
    return x.to(dtype) @ lyr.weight.to(dtype).T + lyr.bias.to(dtype)


def _mlp(layers, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    for lyr in layers:
        x = _leaky(_linear_head(lyr, x, dtype))
    return x


def _density_act(raw: torch.Tensor, act_super: bool) -> torch.Tensor:
    return F.softplus(raw - 1.0) if act_super else F.relu(raw)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1)


def raw_aggregation_weight(cfg: AggregatorConfig, neigh_emb: torch.Tensor,
                           dists: torch.Tensor, pnt_mask: torch.Tensor,
                           grid_vox_sz: float, params: "Aggregator" = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, str]:
    """The un-normalised per-lane weight of `cfg.agg_distance_kernel`
    (every kernel is per lane up to its normalisation over K), in the
    dtype of `dists`. Returns (w [...], the embedding left for the tower,
    norm_kind): "norm" (divide by the weight sum, floor 1e-8), "count"
    (divide by the valid-lane count, floor 1) or "none". sh_intrp,
    gau_intrp and feat_intrp consume a prefix of the embedding channels;
    feat_intrp needs `params` with its `feat_weight_mlp`."""
    kind = cfg.agg_distance_kernel
    mask = pnt_mask.to(dists.dtype)
    emb = neigh_emb
    aw = cfg.axis_weight
    if kind == "linear":
        if aw[0] == 1.0 and aw[2] == 1.0:
            w = mask / torch.clamp(_norm(dists[..., :3]), min=1e-6)
        else:
            w = mask / torch.clamp(
                torch.sqrt((dists[..., :2] ** 2).sum(-1)) * aw[0]
                + torch.abs(dists[..., 2]) * aw[1], min=1e-6)
    elif kind == "numlinear":
        w = mask / torch.clamp(_norm(dists), min=1e-6)
    elif kind == "quadric":
        w = mask / torch.clamp(
            (dists[..., :3] ** 2 * torch.tensor(aw, dtype=dists.dtype,
                                                device=dists.device)
             ).sum(-1), min=1e-8)
    elif kind == "numquadric":
        w = mask / torch.clamp((dists ** 2).sum(-1), min=1e-8)
    elif kind == "avg":
        w = mask
    elif kind == "trilinear":
        d = 1.0 - torch.abs(dists[..., :3] * mask[..., None] / grid_vox_sz)
        w = mask * d[..., 0] * d[..., 1] * d[..., 2]
    elif kind == "sh_intrp":
        n = cfg.sh_degree ** 2
        coefs, emb = emb[..., :n], emb[..., n:]
        dn = _norm(dists[..., :3])
        ddir = dists[..., :3] / torch.clamp(dn[..., None], min=1e-8)
        act = torch.sigmoid if cfg.sh_act == "sigmoid" else torch.tanh
        radial = (1.0 / torch.clamp(dn, min=1e-8)
                  if cfg.sh_dist_func == "sh_linear"
                  else 1.0 / torch.clamp(dn * dn, min=1e-8))
        w = mask * act(sh_basis(ddir, cfg.sh_degree) * coefs).sum(-1) \
            * radial
    elif kind == "gau_intrp":
        scale = torch.abs(emb[..., 0])
        radii = grid_vox_sz * 20.0 * torch.sigmoid(emb[..., 1:4])
        rot = torch.clamp(emb[..., 4:7], -math.pi / 4, math.pi / 4)
        emb = emb[..., 7:]
        local = world2local_dist(dists[..., :3], radii, rot)
        w = mask * scale * torch.exp(-0.5 * (local ** 2).sum(-1))
    elif kind == "feat_intrp":
        # sigmoid(MLP([PE(world delta), feature prefix])), LeakyReLU(0.01)
        if params is None or "feat_weight_mlp" not in params.towers:
            raise ValueError(
                "feat_intrp needs aggregator params (feat_weight_mlp)")
        wf, emb = (emb[..., :cfg.weight_feat_dim],
                   emb[..., cfg.weight_feat_dim:])
        x = torch.cat([positional_encoding(dists[..., :3].float(),
                                           cfg.weight_xyz_freq),
                       wf.float()], -1)
        layers = params.feat_weight_mlp
        for lyr in layers[:-1]:
            x = F.leaky_relu(x @ lyr.weight.T + lyr.bias, 0.01)
        x = x @ layers[-1].weight.T + layers[-1].bias
        w = mask * torch.sigmoid(x[..., 0]).to(dists.dtype)
    else:
        raise ValueError(f"unknown agg_distance_kernel: {kind}")
    if kind.startswith("num"):
        norm_kind = "count"
    elif kind == "trilinear" or cfg.agg_weight_norm:
        norm_kind = "norm"
    else:
        norm_kind = "none"
    return w, emb, norm_kind


def inverse_distance_weight(dists: torch.Tensor, pnt_mask: torch.Tensor,
                            axis_weight=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """The `linear` kernel alone: masked 1 / ||world delta|| (dists
    [..., K, >= 3]), normalised over K (reference studio_model.py:467-475
    and the normalisation at :286)."""
    if axis_weight[0] == 1.0 and axis_weight[2] == 1.0:
        w = 1.0 / torch.clamp(_norm(dists[..., :3]), min=1e-6)
    else:
        w = 1.0 / torch.clamp(
            torch.sqrt((dists[..., :2] ** 2).sum(-1)) * axis_weight[0]
            + torch.abs(dists[..., 2]) * axis_weight[1], min=1e-6)
    w = w * pnt_mask.to(w.dtype)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def aggregation_weight(cfg: AggregatorConfig, neigh_emb: torch.Tensor,
                       dists: torch.Tensor, pnt_mask: torch.Tensor,
                       grid_vox_sz: float, params: "Aggregator" = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-neighbour weights [..., K] of any weight kernel, normalised
    over K as `raw_aggregation_weight` says (reference
    point_aggregators.py:353-483 and :818-819), and the embedding left
    for the tower."""
    w, emb, norm_kind = raw_aggregation_weight(
        cfg, neigh_emb, dists, pnt_mask, grid_vox_sz, params)
    if norm_kind == "norm":
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    elif norm_kind == "count":
        w = w / torch.clamp(pnt_mask.to(w.dtype).sum(-1, keepdim=True),
                            min=1.0)
    return w, emb


def conf_gradient_clamp(conf: torch.Tensor, lo: float = 1e-4,
                        hi: float = 1.0) -> torch.Tensor:
    """conf - stop_gradient(conf - clip(conf)), the reference's expression
    (models/aggregator.py:260-264): clip(conf) forward and a gradient of 1
    everywhere, inside [lo, hi] and outside it. (The reference's docstring
    says the gradient is zeroed outside; its expression does not.)"""
    return conf - (conf - torch.clamp(conf, lo, hi)).detach()


def weight_emb_consumed(cfg: AggregatorConfig) -> int:
    """Embedding channels the weight kernel takes as a prefix before the
    tower (sh_intrp, gau_intrp and feat_intrp)."""
    kind = cfg.agg_distance_kernel
    if kind == "sh_intrp":
        return cfg.sh_degree ** 2
    if kind == "gau_intrp":
        return 7
    if kind == "feat_intrp":
        return cfg.weight_feat_dim
    return 0


@torch.no_grad()
def precompute_base_h(agg: Aggregator, cfg: AggregatorConfig,
                      emb_table: torch.Tensor) -> torch.Tensor:
    """The per-point half of mlp_base's first layer, [N, hidden] bf16:
    [emb, PE(emb)] @ W1[:, :emb rows]^T without the bias, for the
    render's `QueryConfig.base_cache`. Layer 1 is linear, so the tower
    then adds PE(dists) @ W1[dist rows] and the bias per (slot, K) pair
    (`decode_radiance(base_h=)`). The table rounds the partial sum to
    bf16 once, as the reference's does; the embedding's consumed prefix
    (weight_emb_consumed) is cut first, and the encoding uses the
    default PE mode, as the reference's precompute does."""
    dtype = _DTYPES[cfg.compute_dtype]
    emb_c = emb_table[..., weight_emb_consumed(cfg):].to(dtype)
    x = torch.cat([emb_c, positional_encoding(emb_c, cfg.num_feat_freqs)],
                  -1)
    w1 = agg.mlp_base[0].weight[:, :x.shape[-1]].to(dtype)
    return (x @ w1.T).to(torch.bfloat16)


def _base_layer(agg: Aggregator, base_h: torch.Tensor,
                dists_pe: torch.Tensor, dtype) -> torch.Tensor:
    """mlp_base from the cached per-point partial product: layer 1 as
    leaky(base_h + PE(dists) @ W1[dist rows] + b1), then the rest."""
    lyr0 = agg.mlp_base[0]
    w1d = lyr0.weight[:, -dists_pe.shape[-1]:].to(dtype)
    feat = _leaky(base_h.to(dtype) + dists_pe @ w1d.T + lyr0.bias.to(dtype))
    return _mlp(agg.mlp_base[1:], feat, dtype)


def decode_radiance(
    agg: Aggregator,
    cfg: AggregatorConfig,
    neigh_emb: torch.Tensor,     # [M, K, C]
    neigh_color: torch.Tensor,   # [M, K, 3]
    neigh_dir: torch.Tensor,     # [M, K, 3]
    dists: torch.Tensor,         # [M, K, 6] world + perspective offsets
    weight: torch.Tensor,        # [M, K] normalised aggregation weights
    pnt_mask: torch.Tensor,      # [M, K] bool
    viewdirs: torch.Tensor,      # [M, 3] Rw2c-rotated under a global Rw2c
    Rw2c: torch.Tensor,          # [3, 3] global, or [M, K, 3, 3] per point
    base_h: Optional[torch.Tensor] = None,   # [M, K, hidden] per-point
                                 # layer-1 partial products
                                 # (precompute_base_h), orders 1 and 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode (sigma [M], rgb [M, 3]) for M shading points; builds an
    autograd graph where the weights or inputs ask for one.

    Order 0 sums the embeddings over K first and runs the towers once a
    slot, without distance features (point colour and direction modes
    must be off). Orders 1 and 2 run the per-neighbour tower; with a
    per-point Rw2c (edited scenes) the offsets, the point directions and
    the view direction of the direction features rotate per neighbour,
    while the colour branch keeps the slot's own view encoding. With
    `base_h` the embedding's part of mlp_base's first layer comes from
    the cached per-point table."""
    dtype = _DTYPES[cfg.compute_dtype]
    order = cfg.agg_intrp_order
    per_point = Rw2c.ndim == 4
    dir_enc = positional_encoding(viewdirs, cfg.num_viewdir_freqs, ori=True)
    ov, dir_pe = dir_enc[..., :3], dir_enc[..., 3:]
    w = (weight * pnt_mask.to(weight.dtype))[..., None].to(dtype)
    dens = agg.density_head[0]

    if order == 0:
        if cfg.point_color_mode or cfg.point_dir_mode:
            raise ValueError("agg_intrp_order=0 requires point color/dir "
                             "modes off")
        agg_emb = (neigh_emb.to(dtype) * w).sum(-2)               # [M, C]
        feat = torch.cat([agg_emb, positional_encoding(
            agg_emb, cfg.num_feat_freqs, mode=cfg.pe_mode)], -1)
        feat = _mlp(agg.mlp_head, _mlp(agg.mlp_base, feat, dtype), dtype)
        sigma = _density_act(_linear_head(dens, feat, dtype),
                             cfg.act_super)[..., 0]
        agg_feat = feat
    else:
        dists_w = (dists[..., :3, None] * Rw2c).sum(-2)
        dists_rot = torch.cat([dists_w, dists[..., 3:]], -1)
        dists_pe = positional_encoding(dists_rot.to(dtype),
                                       cfg.num_dist_freqs, mode=cfg.pe_mode)
        if base_h is not None:
            feat = _base_layer(agg, base_h, dists_pe, dtype)
        else:
            emb_c = neigh_emb.to(dtype)
            feat = torch.cat([emb_c, positional_encoding(
                emb_c, cfg.num_feat_freqs, mode=cfg.pe_mode), dists_pe], -1)
            feat = _mlp(agg.mlp_base, feat, dtype)

        extras = [feat]
        if cfg.point_color_mode:
            extras.append(neigh_color.to(dtype))
        if cfg.point_dir_mode:
            ndir = (neigh_dir[..., :, None] * Rw2c).sum(-2)
            ovk = ((ov[:, None, :, None] * Rw2c).sum(-2) if per_point
                   else ov[:, None, :])
            extras.append((ndir - ovk).to(dtype))
            extras.append((ndir * ovk).sum(-1, keepdim=True).to(dtype))
        feat = _mlp(agg.mlp_head, torch.cat(extras, -1), dtype)

        if order == 1:
            agg_feat = (feat * w).sum(-2)
            sigma = _density_act(_linear_head(dens, agg_feat, dtype),
                                 cfg.act_super)[..., 0]
        else:
            alpha = _density_act(_linear_head(dens, feat, dtype),
                                 cfg.act_super)
            sigma = (alpha * w).sum(-2)[..., 0]
            agg_feat = (feat * w).sum(-2)
    color_in = torch.cat([agg_feat, dir_pe.to(dtype)], -1)
    cfeat = _mlp(agg.mlp_color, color_in, dtype)
    rgb = torch.sigmoid(_linear_head(agg.color_head[0], cfeat, dtype))
    rgb = rgb * (1 + 2e-3) - 1e-3
    return sigma.float(), rgb.float()


def pair_decode_eligible(cfg: AggregatorConfig, per_point_rw2c: bool) -> bool:
    """Whether `decode_radiance_pairs` serves this aggregator: orders 1
    and 2 with a global Rw2c and fused_decode2 off."""
    return (cfg.agg_intrp_order >= 1 and not per_point_rw2c
            and not cfg.fused_decode2)


def decode_radiance_pairs(
    agg: Aggregator,
    cfg: AggregatorConfig,
    pair_emb: torch.Tensor,      # [MP, C] the valid pairs' features
    pair_color: torch.Tensor,    # [MP, 3]
    pair_dir: torch.Tensor,      # [MP, 3]
    pair_dists: torch.Tensor,    # [MP, 6]
    weight: torch.Tensor,        # [MP] normalised aggregation weights
    pair_valid: torch.Tensor,    # [MP] bool (a prefix of the pairs)
    seg_sum,                     # x [MP, L] -> [n_slots, L] per-slot sums
    seg: torch.Tensor,           # [MP] owning slot, ascending
    viewdirs: torch.Tensor,      # [n_slots, 3]
    Rw2c: torch.Tensor,          # [3, 3] global
    base_h: Optional[torch.Tensor] = None,   # [MP, hidden]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`decode_radiance` (orders 1 and 2) on a packing of the valid
    (slot, K) pairs only: the per-neighbour towers run on the MP pair
    rows, and each slot's K-sums are `seg_sum`, sums over the slot's
    contiguous run of pairs (ops/compositing.segment_sums_contiguous:
    no atomics), in float32 as the reference's segment sums are."""
    dtype = _DTYPES[cfg.compute_dtype]
    if cfg.agg_intrp_order < 1:
        raise ValueError("pair decode requires agg_intrp_order >= 1")
    f32 = torch.float32
    dir_enc = positional_encoding(viewdirs, cfg.num_viewdir_freqs, ori=True)
    ov, dir_pe = dir_enc[..., :3], dir_enc[..., 3:]
    w = (weight * pair_valid.to(weight.dtype))[..., None].to(dtype)
    dists_w = (pair_dists[..., :3, None] * Rw2c).sum(-2)
    dists_rot = torch.cat([dists_w, pair_dists[..., 3:]], -1)
    dists_pe = positional_encoding(dists_rot.to(dtype), cfg.num_dist_freqs,
                                   mode=cfg.pe_mode)
    if base_h is not None:
        feat = _base_layer(agg, base_h, dists_pe, dtype)
    else:
        emb_c = pair_emb.to(dtype)
        feat = torch.cat([emb_c, positional_encoding(
            emb_c, cfg.num_feat_freqs, mode=cfg.pe_mode), dists_pe], -1)
        feat = _mlp(agg.mlp_base, feat, dtype)
    extras = [feat]
    if cfg.point_color_mode:
        extras.append(pair_color.to(dtype))
    if cfg.point_dir_mode:
        ndir = (pair_dir[..., :, None] * Rw2c).sum(-2)
        ovp = ov[seg]
        extras.append((ndir - ovp).to(dtype))
        extras.append((ndir * ovp).sum(-1, keepdim=True).to(dtype))
    feat = _mlp(agg.mlp_head, torch.cat(extras, -1), dtype)
    dens = agg.density_head[0]
    if cfg.agg_intrp_order == 1:
        agg_feat = seg_sum((feat * w).to(f32))
        sigma = _density_act(_linear_head(dens, agg_feat.to(dtype), dtype),
                             cfg.act_super)[..., 0]
    else:
        alpha = _density_act(_linear_head(dens, feat, dtype), cfg.act_super)
        sigma = seg_sum((alpha * w).to(f32))[..., 0]
        agg_feat = seg_sum((feat * w).to(f32))
    color_in = torch.cat([agg_feat.to(dtype), dir_pe.to(dtype)], -1)
    cfeat = _mlp(agg.mlp_color, color_in, dtype)
    rgb = torch.sigmoid(_linear_head(agg.color_head[0], cfeat, dtype))
    rgb = rgb * (1 + 2e-3) - 1e-3
    return sigma.float(), rgb.float()
