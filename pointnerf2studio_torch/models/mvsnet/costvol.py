"""Learned depth-probability point generation (joint MVS training).

Port of `pointnerf2studio_tpu/models/mvsnet/costvol.py`, the reference's
`manual_depth_view == -1` stack, the trainable alternative to the
pretrained-MVSNet depth path used when MVS and Point-NeRF are optimised
jointly (reference: pointnerf/models/mvs/models.py:660-684
`create_mvs(mvs_mode=-1)`, models.py:885-1003
`MVSNet.build_volume_costvar_img`/`forward`, models.py:766-821
`CostRegNet`/`ProbNet`, and pointnerf/models/mvs/mvs_points_model.py:
141-167 `gau_single_sampler` / `prob_filter`):

  FPN features (1/4 res, 32ch)
  -> plane-sweep cost volume at D depth bins over [near, far]:
       [ref RGB, warped src RGBs, variance of warped features]
       = 3*V + 32 channels (V views, pad `pad` pixels)
  -> CostRegNet 3-D U-Net -> 8-channel volume
  -> ProbNet (1x conv3d + BN) -> softmax over depth = depth probability
  -> expected depth + std per pixel, prob_filter mask.

The cost volume is `ops/costvol.py::cost_volume`, an autograd Function
(the kernels of `csrc/costvol.cu` on the card) on the sweep's coordinates;
`build_cost_volume_composite` keeps the torch composite it replaced as
the tests' yardstick.

Kept as the reference has it: models.py's ConvBnReLU3D applies NO ReLU
(`bn(conv(x))`, models.py:697-713), nor do the transposed stages here.

`CostVolParams` holds `costreg` and `probnet`. The pretrained
`best_net_mvs.pth` does not carry this stack (the reference's DTU init
has no learned-depth weights), so the repo has no checkpoint that names
its keys; they follow the JAX tree's names.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn

from pointnerf2studio_torch.models.mvsnet.featurenet import (
    FeatureNet, make_premlp)
from pointnerf2studio_torch.models.mvsnet.layers import (
    BatchNorm, ConvBn, bilinear_grid_sample, edge_pad8, f32_convs, from_cf,
    to_cf)
from pointnerf2studio_torch.models.mvsnet.mvsnet import CostRegNet
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.costvol import cost_volume
from pointnerf2studio_torch.ops.raygen import _unit_steps


class CostVolParams(nn.Module):
    """CostRegNet(3V+32 -> 8ch, no ReLU) + ProbNet(8 -> 1)
    (models.py:766-821)."""

    def __init__(self, num_views: int = 3):
        super().__init__()
        self.costreg = CostRegNet(3 * num_views + 32, relu=False, out8=True)
        self.probnet = ConvBn(8, 1, 3, 1, 1, relu=False, three_d=True)


@torch.no_grad()
def xavier_init_(module: nn.Module, generator: torch.Generator,
             gains=None) -> nn.Module:
    """Xavier-uniform conv and linear weights from `generator` (fan-in and
    fan-out over the receptive field, as the reference's `init_weights`
    default, helpers/networks.py:126-141), zero biases, BatchNorm at
    identity (scale 1, bias 0, mean 0, var 1)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                          nn.Linear)):
            w = m.weight
            rf = w[0, 0].numel()
            fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
            gain = (gains or {}).get(name, 1.0)
            lim = gain * math.sqrt(6.0 / (fan_in + fan_out))
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1)
                    .mul_(lim).to(w.device))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module


def init_fpn_params(generator: torch.Generator,
                    device: torch.device | str | None = None) -> FeatureNet:
    """Random-init FeatureNet(intermediate=True) (models.py:716-764)."""
    device = resolve_device(device)
    return xavier_init_(FeatureNet(), generator).to(device)


def init_premlp_params(generator: torch.Generator, in_dim: int = 63,
                       out_dim: int = 32, num_layers: int = 1,
                       device: torch.device | str | None = None
                       ) -> nn.Sequential:
    """premlp: Linear/ReLU stack embedding warped features -> point
    features (mvs_points_model.py:21-32); ReLU gain on all but the last
    Linear."""
    device = resolve_device(device)
    seq = make_premlp(num_layers, in_dim, out_dim)
    lin = [str(i) for i, m in enumerate(seq) if isinstance(m, nn.Linear)]
    gains = {n: math.sqrt(2.0) for n in lin[:-1]}
    return xavier_init_(seq, generator, gains).to(device)


def init_costvol_params(generator: torch.Generator, num_views: int = 3,
                        device: torch.device | str | None = None
                        ) -> CostVolParams:
    """CostRegNet(3V+32 -> 8ch) + ProbNet(8 -> 1) (models.py:766-821)."""
    device = resolve_device(device)
    return xavier_init_(CostVolParams(num_views), generator).to(device)


def cost_reg_net8(p: CostRegNet, vol: torch.Tensor) -> torch.Tensor:
    """[D, h, w, Cin] -> [D, h, w, 8] (models.py:766-810; unlike the
    depth estimator's CostRegNet this one keeps an 8-channel output and
    applies no ReLU anywhere). Dims are edge-padded to multiples of 8 and
    cropped back."""
    D0, H0, W0 = vol.shape[:3]
    with f32_convs():
        x = p.unet(edge_pad8(to_cf(vol)))
    return from_cf(x[:, :, :D0, :H0, :W0])


def prob_net(p: ConvBn, vol8: torch.Tensor) -> torch.Tensor:
    """[D, h, w, 8] -> depth probability [D, h, w] (softmax over D;
    models.py:812-821)."""
    with f32_convs():
        x = p(to_cf(vol8))[0, 0]
    return torch.softmax(x, 0)


def _sweep_grid(proj: torch.Tensor, depth_values: torch.Tensor, Hp: int,
                Wp: int, pad: int, h: int, w: int):
    """(gx, gy) [D, Hp, Wp]: the normalised source coordinates of the
    padded ref pixel grid at each depth plane (mvs_utils.py:423-473: the
    ref grid shifted by -pad, src = R @ ref + T / depth)."""
    D = depth_values.shape[0]
    dev = proj.device
    y, x = torch.meshgrid(
        torch.arange(Hp, dtype=torch.float32, device=dev) - pad,
        torch.arange(Wp, dtype=torch.float32, device=dev) - pad,
        indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(Hp * Wp, device=dev)], 0)      # [3, HW]
    rot, trans = proj[:3, :3], proj[:3, 3]
    rd = rot @ xyz                                                # [3, HW]
    proj_xyz = rd[:, None, :] + (trans[:, None] / depth_values)[:, :, None]
    z = proj_xyz[2]
    xy = proj_xyz[:2] / torch.where(torch.abs(z) < 1e-9,
                                    torch.full_like(z, 1e-9), z)
    gx = (xy[0] / ((w - 1) / 2) - 1).reshape(D, Hp, Wp)
    gy = (xy[1] / ((h - 1) / 2) - 1).reshape(D, Hp, Wp)
    return gx, gy


def homo_warp_pad(feat: torch.Tensor, proj: torch.Tensor,
                  depth_values: torch.Tensor, pad: int) -> torch.Tensor:
    """Warp a source map into the (padded) ref frustum per depth plane:
    feat [H, W, C]; proj [4, 4] = src_proj @ inv(ref_proj) at feat res;
    depth_values [D] -> [D, H+2p, W+2p, C] (mvs_utils.homo_warp,
    mvs_utils.py:423-473: grid_sample align_corners=True, zero padding
    outside)."""
    H, W, _ = feat.shape
    Hp, Wp = H + 2 * pad, W + 2 * pad
    gx, gy = _sweep_grid(proj, depth_values, Hp, Wp, pad, H, W)
    return bilinear_grid_sample(feat, torch.stack([gx, gy], -1),
                                align_corners=True)


def build_cost_volume(
    imgs_q: torch.Tensor,        # [V, h, w, 3] images at feature res
    feats: torch.Tensor,         # [V, h, w, 32] FPN top-level features
    proj_mats: torch.Tensor,     # [V, 4, 4] src @ inv(ref) at feature res
    depth_values: torch.Tensor,  # [D]
    vid: int = 0,
    pad: int = 0,
) -> torch.Tensor:
    """[D, h+2p, w+2p, 3V+32] cost volume (models.py:891-946): channels =
    [ref RGB (broadcast over D), each warped src RGB, variance of (ref +
    warped src) features over the views whose sample lands inside
    (-1, 1)^2 (models.py:930-933)]. The sweep's coordinates come from
    `_sweep_grid`; the warp, the variance and the concatenation are
    `ops/costvol.py::cost_volume` (the kernels of `csrc/costvol.cu` on the
    card), equal to `build_cost_volume_composite` bit for bit.
    Differentiable in feats only."""
    V, h, w, _ = feats.shape
    Hp, Wp = h + 2 * pad, w + 2 * pad
    grids = [_sweep_grid(proj_mats[v], depth_values, Hp, Wp, pad, h, w)
             for v in range(V) if v != vid]
    return cost_volume(feats, imgs_q, grids, vid=vid, pad=pad)


def build_cost_volume_composite(
    imgs_q: torch.Tensor,        # [V, h, w, 3] images at feature res
    feats: torch.Tensor,         # [V, h, w, 32] FPN top-level features
    proj_mats: torch.Tensor,     # [V, 4, 4] src @ inv(ref) at feature res
    depth_values: torch.Tensor,  # [D]
    vid: int = 0,
    pad: int = 0,
) -> torch.Tensor:
    """`build_cost_volume` as torch ops under autograd: four
    `bilinear_grid_sample` taps a source view, the variance, the
    concatenation. No path of the program calls it: the tests and
    `chip_smoke.py` hold `ops/costvol.py` to it."""
    V, h, w, C = feats.shape
    D = depth_values.shape[0]
    Hp, Wp = h + 2 * pad, w + 2 * pad

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0, pad, pad, pad, pad))

    ref_feat = padded(feats[vid])
    vol_sum = ref_feat[None].expand(D, Hp, Wp, C)
    vol_sq = vol_sum ** 2
    in_cnt = torch.ones((D, Hp, Wp), device=feats.device)
    rgb_layers: List[torch.Tensor] = [
        padded(imgs_q[vid])[None].expand(D, Hp, Wp, 3)]
    for v in range(V):
        if v == vid:
            continue
        gx, gy = _sweep_grid(proj_mats[v], depth_values, Hp, Wp, pad, h, w)
        warped = bilinear_grid_sample(
            torch.cat([feats[v], imgs_q[v]], -1), torch.stack([gx, gy], -1),
            align_corners=True)                                  # [D,Hp,Wp,C+3]
        wf, wrgb = warped[..., :C], warped[..., C:]
        vol_sum = vol_sum + wf
        vol_sq = vol_sq + wf ** 2
        rgb_layers.append(wrgb)
        inm = (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
        in_cnt = in_cnt + inm.to(torch.float32)
    cnt = 1.0 / in_cnt[..., None]
    variance = vol_sq * cnt - (vol_sum * cnt) ** 2
    return torch.cat(rgb_layers + [variance], -1)


def depth_values_linear(near, far, num_depth: int,
                        device=None) -> torch.Tensor:
    """[D] depth planes linear in depth over [near, far] (models.py:
    964-968, lindisp off), at the values of the reference's
    linspace(0, 1, D)."""
    t = _unit_steps(num_depth, torch.float32, device)
    return near * (1 - t) + far * t


def depth_probability(
    params: CostVolParams,
    imgs_q: torch.Tensor,
    feats: torch.Tensor,
    proj_mats: torch.Tensor,
    near_far: Tuple,
    num_depth: int = 128,
    vid: int = 0,
    pad: int = 0,
) -> torch.Tensor:
    """Full learned-depth forward: cost volume -> CostRegNet -> ProbNet.
    Returns prob [D, h+2p, w+2p] (softmax over depth)."""
    near, far = near_far
    dv = depth_values_linear(near, far, num_depth, feats.device)
    vol = build_cost_volume(imgs_q, feats, proj_mats, dv, vid=vid, pad=pad)
    vol8 = cost_reg_net8(params.costreg, vol)
    return prob_net(params.probnet, vol8)


def expected_depth_std(prob: torch.Tensor, dprob_thresh: float = 0.8,
                       num_neighbor: int = 1):
    """Per-pixel NDC expected depth, std, and prob_filter mask
    (mvs_points_model.py:141-150,184-196).

    The reference's prob_filter gathers `num_neighbor` probability bins
    around ceil(expected_ndc_depth), an NDC depth in [0, 1] and not a bin
    index: ceil gives 1, so with the default num_neighbor=1 the mask is
    prob[bin 2] > thresh. The literal computation is kept. The std's
    gradient is 0 where the variance is 0 (the reference's is NaN)."""
    D = prob.shape[0]
    v = 1.0 / D
    ndc_depths = (torch.arange(D, dtype=torch.float32, device=prob.device)
                  * v + 0.5 * v)[:, None, None]
    e = (prob * ndc_depths).sum(0)                                # [h, w]
    var = (prob * (ndc_depths - e) ** 2).sum(0)
    # sqrt's derivative is infinite at 0: where a pixel's probability has
    # gone to one bin in float32 the reference's gradient is NaN there and
    # reaches every weight of the step (ROADMAP §3). The same value, with
    # a zero gradient at var == 0.
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var,
                                                  torch.ones_like(var))),
                      torch.zeros_like(var))
    ceil_idx = torch.ceil(e)
    lower = ceil_idx - num_neighbor // 2 + 1
    shifts = torch.arange(num_neighbor, dtype=torch.float32,
                          device=prob.device)[:, None, None]
    idx = torch.clamp(lower[None] + shifts, 0, D - 1).to(torch.int64)
    sel = torch.gather(prob, 0, idx)
    mask = sel.sum(0) > dprob_thresh
    return e, std, mask
