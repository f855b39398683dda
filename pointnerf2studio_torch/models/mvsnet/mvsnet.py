"""MVSNet depth estimation (pretrained, inference).

Port of `pointnerf2studio_tpu/models/mvsnet/mvsnet.py`, the official
MVSNet the reference uses for point-cloud initialisation (reference:
pointnerf/models/mvs/depth_estimators/mvsnet.py:7-143 and module.py:
36-85): FeatureNet (stride 4, 32ch), homography-warped variance cost
volume, CostRegNet 3-D U-Net, softmax -> depth regression + 4-window
photometric confidence. `MVSNet` has the checkpoint's names (`feature.*`,
`cost_regularization.*`), so `model_000014.ckpt` loads into it with
strict=True once `module.` is stripped.

Where the reference decides on a float edge the port does the same
literally: the expectation index is truncated to an integer
(`mvsnet.py:170-172` there), so on the card a depth whose expected index
lies within rounding of an integer can pick the other neighbour; tests
count such disagreements and bound them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointnerf2studio_torch.models.mvsnet.layers import (
    ConvBn, ConvTransposeBn, bilinear_grid_sample, edge_pad8, f32_convs,
    from_cf, load_checkpoint_dict, load_prefixed, to_cf)
from pointnerf2studio_torch.ops._cuda import resolve_device


class MVSFeatureNet(nn.Module):
    """The official MVSNet FeatureNet: 8 ConvBnReLU stages, stride 4,
    then a 3x3 `feature` conv to 32 channels."""

    def __init__(self):
        super().__init__()
        spec = [(3, 8, 3, 1, 1), (8, 8, 3, 1, 1), (8, 16, 5, 2, 2),
                (16, 16, 3, 1, 1), (16, 16, 3, 1, 1), (16, 32, 5, 2, 2),
                (32, 32, 3, 1, 1)]
        for i, (ci, co, k, s, p) in enumerate(spec):
            setattr(self, f"conv{i}", ConvBn(ci, co, k, s, p))
        self.feature = nn.Conv2d(32, 32, 3, 1, 1)


class CostRegNet(nn.Module):
    """3-D U-Net with ReLU in every ConvBn and after each transposed
    stage, then a `prob` conv to one channel."""

    def __init__(self, cin: int = 32, relu: bool = True, out8: bool = False):
        super().__init__()
        spec = [(cin, 8, 1), (8, 16, 2), (16, 16, 1), (16, 32, 2),
                (32, 32, 1), (32, 64, 2), (64, 64, 1)]
        for i, (ci, co, s) in enumerate(spec):
            setattr(self, f"conv{i}",
                    ConvBn(ci, co, 3, s, 1, relu=relu, three_d=True))
        self.conv7 = ConvTransposeBn(64, 32, relu)
        self.conv9 = ConvTransposeBn(32, 16, relu)
        self.conv11 = ConvTransposeBn(16, 8, relu)
        if not out8:
            self.prob = nn.Conv3d(8, 1, 3, stride=1, padding=1)

    def unet(self, x: torch.Tensor) -> torch.Tensor:
        """[1, Cin, D, H, W] (each of D, H, W a multiple of 8) -> [1, 8,
        D, H, W]."""
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        x = c2 + self.conv9(x)
        return c0 + self.conv11(x)


class MVSNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature = MVSFeatureNet()
        self.cost_regularization = CostRegNet()


MVSNetParams = MVSNet


def load_mvsnet_params(path: str, device: torch.device | str | None = None
                       ) -> MVSNet:
    """Import the official-MVSNet checkpoint (`{"model": {"module.<key>":
    ...}}` or a bare state dict) onto `device` (None: the card)."""
    device = resolve_device(device)
    sd = load_checkpoint_dict(path, strip="module.")
    net = load_prefixed(MVSNet(), sd, ("feature.", "cost_regularization."))
    return net.to(device)


def feature_net(p: MVSFeatureNet, img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] (or [V, H, W, 3]) -> [H/4, W/4, 32] (mvsnet.py:7-27)."""
    batched = img.ndim == 4
    x = img.permute(0, 3, 1, 2) if batched else to_cf(img)
    with f32_convs():
        for i in range(7):
            x = getattr(p, f"conv{i}")(x)
        x = p.feature(x)
    return x.permute(0, 2, 3, 1) if batched else from_cf(x)


def cost_reg_net(p: CostRegNet, vol: torch.Tensor) -> torch.Tensor:
    """3-D U-Net regularisation [D, H, W, 32] -> [D, H, W] raw cost
    (mvsnet.py:30-70). Every dim is edge-padded up to a multiple of 8 for
    the transposed stages' skip adds and the output cropped back, as the
    reference does for image sizes such as 400^2 (100-wide features)."""
    D0, H0, W0 = vol.shape[:3]
    with f32_convs():
        x = p.unet(edge_pad8(to_cf(vol)))
        x = p.prob(x)
    return x[0, 0, :D0, :H0, :W0]


def _pixel_grid(H: int, W: int, device, shift: float = 0.0):
    y, x = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) - shift,
        torch.arange(W, dtype=torch.float32, device=device) - shift,
        indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1),
                        torch.ones(H * W, device=device)], 0)      # [3, HW]


def homo_warp(feat: torch.Tensor, proj: torch.Tensor,
              depth_values: torch.Tensor,
              align_corners: bool = False) -> torch.Tensor:
    """Warp a source feature map into the ref frustum per depth plane.

    feat [H, W, C]; proj = src_proj @ inv(ref_proj) [4, 4] (3x4 used);
    depth_values [D]. Returns [D, H, W, C] (reference: module.py:36-71;
    torch >= 1.3 samples with align_corners=False)."""
    H, W, C = feat.shape
    D = depth_values.shape[0]
    rot, trans = proj[:3, :3], proj[:3, 3]
    xyz = _pixel_grid(H, W, feat.device)
    rot_xyz = rot @ xyz                                           # [3, HW]
    rd = rot_xyz[:, None, :] * depth_values[None, :, None]        # [3, D, HW]
    proj_xyz = rd + trans[:, None, None]
    z = proj_xyz[2]
    xy = proj_xyz[:2] / z                                         # [2, D, HW]
    gx = xy[0] / ((W - 1) / 2) - 1
    gy = xy[1] / ((H - 1) / 2) - 1
    grid = torch.stack([gx, gy], -1).reshape(D, H, W, 2)
    return bilinear_grid_sample(feat, grid, align_corners=align_corners)


def variance_volume(params: MVSNet, imgs: torch.Tensor,
                    proj_mats: torch.Tensor,
                    depth_values: torch.Tensor) -> torch.Tensor:
    """The cost volume [D, H/4, W/4, 32]: the variance over the V views of
    their features warped into the reference frustum (the first stage of
    `mvsnet_depth`)."""
    V = imgs.shape[0]
    feats = feature_net(params.feature, imgs)                     # [V,h,w,32]
    vol_sum = vol_sq = None
    for v in range(V):
        warped = homo_warp(feats[v], proj_mats[v], depth_values)
        vol_sum = warped if vol_sum is None else vol_sum + warped
        sq = warped ** 2
        vol_sq = sq if vol_sq is None else vol_sq + sq
        del warped, sq
    return vol_sq / V - (vol_sum / V) ** 2


def mvsnet_depth(
    params: MVSNet,
    imgs: torch.Tensor,           # [V, H, W, 3] ref first
    proj_mats: torch.Tensor,      # [V, 4, 4] src @ inv(ref) convention
    depth_values: torch.Tensor,   # [D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth + photometric confidence for the reference view: (depth
    [H/4, W/4], conf [H/4, W/4], prob_volume [D, H/4, W/4]). MVSNet.forward
    (mvsnet.py:98-143): variance cost volume over warped features,
    CostRegNet, softmax over depth, expectation depth, the 4-window summed
    probability at the truncated expectation index."""
    D = depth_values.shape[0]
    variance = variance_volume(params, imgs, proj_mats, depth_values)
    cost = cost_reg_net(params.cost_regularization, variance)     # [D, h, w]
    del variance
    prob = torch.softmax(cost, 0)
    depth = (prob * depth_values[:, None, None]).sum(0)

    # photometric confidence: the sum of 4 adjacent depth probabilities
    # around the expectation index (mvsnet.py:132-136: avg_pool3d over a
    # (4, 1, 1) window after padding (1, 2) along depth, x4)
    pp = F.pad(prob, (0, 0, 0, 0, 1, 2))
    prob4 = pp[:-3] + pp[1:-2] + pp[2:-1] + pp[3:]                # [D, h, w]
    didx = (prob * torch.arange(D, dtype=torch.float32,
                                device=prob.device)[:, None, None]
            ).sum(0).to(torch.int64)
    conf = torch.gather(prob4, 0, didx[None])[0]
    return depth, conf, prob


def random_mvsnet_checkpoint(path: str, seed: int = 0) -> str:
    """Write random depth-net weights (`layers.random_` from a CPU
    generator seeded with `seed`) to `path` in `model_000014.ckpt`'s
    layout: {"model": {"module.<key>": tensor}}. Random weights are not a
    depth estimator: their softmax over depth is flat."""
    from pointnerf2studio_torch.models.mvsnet.layers import random_
    net = random_(MVSNet(), torch.Generator().manual_seed(seed))
    torch.save({"model": {f"module.{k}": v for k, v in
                          net.state_dict().items()}}, path)
    return path
