"""Radiance decoder: the per-neighbour MLP tower and K-aggregation.

Port of `pointnerf2studio_tpu/models/aggregator.py` for the served
configuration: aggregation orders 1 and 2, the `linear` inverse-distance
weight, a global Rw2c, float32 or bfloat16 compute.

Tower (all LeakyReLU(0.1), including output activations):
  mlp_base:  [emb(32), PE_3(emb)(192), PE_5(dists@Rw2c)(60)] -> 2x256
  mlp_head:  [base(256), colour(3), dir-viewdir(3), dot(1)] -> 2x256
  density:   Linear(256 -> 1) + ReLU (softplus(x - 1) under act_super)
  mlp_color: [sum_K(w * head)(256), PE_4(viewdir)(24)] -> 3x128
  rgb:       Linear(128 -> 3) + sigmoid, squashed *1.002 - 0.001

Weights live in `Aggregator`, an nn.Module whose towers are ModuleLists
of nn.Linear (weight [out, in]; the JAX tree keeps kernels [in, out],
see convert.py). Forward-only in this port: nothing here needs autograd.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.ops.encoding import positional_encoding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
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

    return {
        "mlp_base": tower(base_in, cfg.hidden_size, cfg.num_mlp_base_layers),
        "mlp_head": tower(head_in, cfg.hidden_size, cfg.num_mlp_head_layers),
        "mlp_color": tower(color_in, cfg.hidden_size_color,
                           cfg.num_color_layers),
        "density_head": [(cfg.hidden_size, 1)],
        "color_head": [(cfg.hidden_size_color, 3)],
    }


class Aggregator(nn.Module):
    """The decoder's weights: one ModuleList of nn.Linear per tower."""

    def __init__(self, cfg: AggregatorConfig, seed: int = 0,
                 device: torch.device | str = "cpu"):
        super().__init__()
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
        # forward-only in this port: nothing trains through it yet
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


def aggregation_weight(cfg: AggregatorConfig, dists: torch.Tensor,
                       pnt_mask: torch.Tensor) -> torch.Tensor:
    """`linear` kernel: masked 1/||world delta|| normalised over K
    (reference studio_model.py:467-475 and :286)."""
    if cfg.agg_distance_kernel != "linear":
        raise NotImplementedError(
            f"agg_distance_kernel={cfg.agg_distance_kernel!r} is not ported")
    mask = pnt_mask.to(dists.dtype)
    aw = cfg.axis_weight
    if aw[0] == 1.0 and aw[2] == 1.0:
        w = mask / torch.clamp(torch.linalg.norm(dists[..., :3], dim=-1),
                               min=1e-6)
    else:
        w = mask / torch.clamp(
            torch.sqrt((dists[..., :2] ** 2).sum(-1)) * aw[0]
            + torch.abs(dists[..., 2]) * aw[1], min=1e-6)
    if cfg.agg_weight_norm:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    return w


@torch.no_grad()
def decode_radiance(
    agg: Aggregator,
    cfg: AggregatorConfig,
    neigh_emb: torch.Tensor,     # [M, K, C]
    neigh_color: torch.Tensor,   # [M, K, 3]
    neigh_dir: torch.Tensor,     # [M, K, 3]
    dists: torch.Tensor,         # [M, K, 6] world + perspective offsets
    weight: torch.Tensor,        # [M, K] normalised aggregation weights
    pnt_mask: torch.Tensor,      # [M, K] bool
    viewdirs: torch.Tensor,      # [M, 3] Rw2c-rotated view directions
    Rw2c: torch.Tensor,          # [3, 3] global rotation
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode (sigma [M], rgb [M, 3]) for M shading points."""
    if cfg.agg_intrp_order not in (1, 2) or Rw2c.ndim != 2:
        raise NotImplementedError(
            "decode_radiance is ported for agg_intrp_order 1/2 with a "
            "global Rw2c")
    dtype = _DTYPES[cfg.compute_dtype]
    dir_enc = positional_encoding(viewdirs, cfg.num_viewdir_freqs, ori=True)
    ov, dir_pe = dir_enc[..., :3], dir_enc[..., 3:]
    w = (weight * pnt_mask.to(weight.dtype))[..., None].to(dtype)

    dists_w = (dists[..., :3, None] * Rw2c).sum(-2)
    dists_rot = torch.cat([dists_w, dists[..., 3:]], -1)
    dists_pe = positional_encoding(dists_rot.to(dtype), cfg.num_dist_freqs,
                                   mode=cfg.pe_mode)
    emb_c = neigh_emb.to(dtype)
    feat = torch.cat([emb_c, positional_encoding(
        emb_c, cfg.num_feat_freqs, mode=cfg.pe_mode), dists_pe], -1)
    feat = _mlp(agg.mlp_base, feat, dtype)

    extras = [feat]
    if cfg.point_color_mode:
        extras.append(neigh_color.to(dtype))
    if cfg.point_dir_mode:
        ndir = (neigh_dir[..., :, None] * Rw2c).sum(-2)
        ovk = ov[:, None, :]
        extras.append((ndir - ovk).to(dtype))
        extras.append((ndir * ovk).sum(-1, keepdim=True).to(dtype))
    feat = _mlp(agg.mlp_head, torch.cat(extras, -1), dtype)

    dens = agg.density_head[0]
    if cfg.agg_intrp_order == 1:
        agg_feat = (feat * w).sum(-2)
        sigma = _density_act(_linear_head(dens, agg_feat, dtype),
                             cfg.act_super)[..., 0]
    else:
        alpha = _density_act(_linear_head(dens, feat, dtype), cfg.act_super)
        sigma = (alpha * w).sum(-2)[..., 0]
        agg_feat = (feat * w).sum(-2)
    color_in = torch.cat([agg_feat, dir_pe.to(dtype)], -1)
    cfeat = _mlp(agg.mlp_color, color_in, dtype)
    rgb = torch.sigmoid(_linear_head(agg.color_head[0], cfeat, dtype))
    rgb = rgb * (1 + 2e-3) - 1e-3
    return sigma.float(), rgb.float()
