"""Training losses.

Port of `pointnerf2studio_tpu/train/loss.py` (reference:
`PointNerf.get_loss_dict`, pointnerf/nerfstudio/studio_model.py:415-431,
and the loss registry of base_rendering_model.py:533-663): every dynamic
`masked_select` mean is a mask-weighted sum over a mask count. As in the
reference, the zero-one term averages over valid neighbour slots only.
The reference's `psum_axis` (sums across a device mesh) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pointnerf2studio_torch.config import TrainConfig


def compute_losses(
    out,                                        # a render output
    gt_rgb: torch.Tensor,                       # [R, 3]
    t: TrainConfig,
    gt_mask: Optional[torch.Tensor] = None,     # [R] 1 = foreground
    gt_depth: Optional[torch.Tensor] = None,    # [R]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {part name: value}) over `out`'s coarse_raycolor,
    ray_mask, acc, depth, conf_coefficient, pnt_mask and weight."""
    parts: Dict[str, torch.Tensor] = {}
    color = out.coarse_raycolor
    total = torch.zeros((), dtype=torch.float32, device=color.device)
    ray_mask_f = out.ray_mask.to(torch.float32)[:, None]         # [R, 1]

    for name, wgt in zip(t.color_loss_items, t.color_loss_weights):
        se = torch.square(color - gt_rgb)
        if name.startswith("ray_masked_"):
            loss = (se * ray_mask_f).sum() / torch.clamp(
                ray_mask_f.sum() * 3.0, min=1.0)
        elif name.startswith("ray_miss_"):
            # MSE over missed rays times the miss count (reference
            # :553-562 multiplies the mean back by N_miss)
            loss = (se * (1.0 - ray_mask_f)).sum() / 3.0
        elif name.startswith("ray_depth_masked_"):
            # rays whose ground-truth depth is valid; on blender data the
            # alpha-foreground mask
            if gt_depth is not None:
                dm = (gt_depth > 0).to(torch.float32)[:, None]
            elif gt_mask is not None:
                dm = gt_mask.to(torch.float32)[:, None]
            else:
                dm = torch.ones_like(ray_mask_f)
            loss = (se * dm).sum() / torch.clamp(dm.sum() * 3.0, min=1.0)
        else:
            loss = se.sum() / max(float(se.numel()), 1.0)
        total = total + loss * wgt + 1e-6
        parts[f"{name}_loss"] = loss

    if t.depth_loss_weight > 0.0 and gt_depth is not None:
        m = gt_mask.to(torch.float32) if gt_mask is not None else 1.0
        se = torch.square((out.depth - gt_depth) * m)
        loss = se.sum() / max(float(se.numel()), 1.0)
        total = total + loss * t.depth_loss_weight
        parts["depth_loss"] = loss

    if t.bg_loss_weight > 0.0 and gt_mask is not None:
        bg = 1.0 - gt_mask.to(torch.float32)
        se = torch.square((1.0 - out.acc) * bg - bg)
        loss = se.sum() / max(float(se.numel()), 1.0)
        total = total + loss * t.bg_loss_weight
        parts["bg_loss"] = loss

    if t.zero_one_loss_weight > 0.0:
        v = torch.clamp(out.conf_coefficient, t.zero_epsilon,
                        1.0 - t.zero_epsilon)
        pm = out.pnt_mask.to(torch.float32)
        zo = ((torch.log(v) + torch.log(1.0 - v)) * pm).sum() / torch.clamp(
            pm.sum(), min=1.0)
        loss = zo * t.zero_one_loss_weight
        total = total + loss
        parts["conf_coefficient_loss"] = loss

    if t.sparse_loss_weight > 0.0 and out.weight is not None:
        # sum(w * |1 - exp(-2 conf)|) / sum(w) (reference :652-662)
        w = out.weight * out.pnt_mask.to(out.weight.dtype)
        num = (w * torch.abs(1.0 - torch.exp(-2.0 * out.conf_coefficient))
               ).sum()
        loss = num / (w.sum() + 1e-6)
        total = total + loss * t.sparse_loss_weight
        parts["sparse_loss"] = loss

    parts["total"] = total
    return total, parts


def compute_loss(out, gt_rgb: torch.Tensor, zero_epsilon: float = 1e-3,
                 zero_one_weight: float = 1e-4
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`compute_losses` under a TrainConfig that sets only the zero-one
    term's epsilon and weight (the other fields at their defaults)."""
    t = TrainConfig(zero_epsilon=zero_epsilon,
                    zero_one_loss_weight=zero_one_weight)
    return compute_losses(out, gt_rgb, t)


def masked_psnr(out, gt_rgb: torch.Tensor) -> torch.Tensor:
    """PSNR over the rays that hit the scene (reference
    utils/visualizer.py:142-152)."""
    m = out.ray_mask.to(torch.float32)[:, None]
    mse = (torch.square(out.coarse_raycolor - gt_rgb) * m).sum() / torch.clamp(
        m.sum() * 3.0, min=1.0)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
