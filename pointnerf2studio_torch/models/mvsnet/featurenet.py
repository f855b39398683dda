"""FPN FeatureNet + premlp: per-point appearance embeddings.

Port of `pointnerf2studio_tpu/models/mvsnet/featurenet.py` (reference:
pointnerf/models/mvs/models.py:716-764 FeatureNet(intermediate=True), and
the premlp applied in mvs_points_model.py:query_embedding:255-257). The
modules carry `best_net_mvs.pth`'s names: `FPNParams` has the children
`FeatureNet` and `premlp`, so that checkpoint loads into it with
strict=True.

Kept as the reference has it: its `ConvBnReLU` in models.py has NO ReLU in
its forward (`bn(conv(x))`, models.py:697-698).

In intermediate mode the net returns 4 levels: the raw image (layer 0,
used as point colour), conv0 (8ch, full res), conv1 (16ch, 1/2 res),
toplayer(conv2) (32ch, 1/4 res).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from pointnerf2studio_torch.models.mvsnet.layers import (
    ConvBn, f32_convs, from_cf, load_checkpoint_dict, load_prefixed)
from pointnerf2studio_torch.ops._cuda import resolve_device


class FeatureNet(nn.Module):
    """FeatureNet(intermediate=True): 3 -> 8 -> 16 -> 32 channels at
    1, 1/2 and 1/4 resolution, no ReLU, a 1x1 `toplayer` on the last."""

    def __init__(self):
        super().__init__()

        def cb(i, o, k, s, p):
            return ConvBn(i, o, k, s, p, relu=False)

        self.conv0 = nn.Sequential(cb(3, 8, 3, 1, 1), cb(8, 8, 3, 1, 1))
        self.conv1 = nn.Sequential(cb(8, 16, 5, 2, 2), cb(16, 16, 3, 1, 1),
                                   cb(16, 16, 3, 1, 1))
        self.conv2 = nn.Sequential(cb(16, 32, 5, 2, 2), cb(32, 32, 3, 1, 1),
                                   cb(32, 32, 3, 1, 1))
        self.toplayer = nn.Conv2d(32, 32, 1)


def make_premlp(num_layers: int = 2, in_dim: int = 63,
                out_dim: int = 32) -> nn.Sequential:
    """Linear layers with a ReLU between each two (num_layers 2:
    `premlp.0` and `premlp.2`, as `best_net_mvs.pth` stores them)."""
    layers: List[nn.Module] = []
    d = in_dim
    for i in range(num_layers):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Linear(d, out_dim))
        d = out_dim
    return nn.Sequential(*layers)


class FPNParams(nn.Module):
    """The FPN with its premlp, the layout of `best_net_mvs.pth`."""

    def __init__(self, premlp_layers: Optional[int] = 2):
        super().__init__()
        self.FeatureNet = FeatureNet()
        if premlp_layers:
            self.premlp = make_premlp(premlp_layers)


def load_fpn_params(path: str, device: torch.device | str | None = None
                    ) -> FPNParams:
    """Import best_net_mvs.pth (FeatureNet.* + premlp.*) onto `device`
    (None: the card). Keys of other children are ignored, as the
    reference's import reads only these."""
    device = resolve_device(device)
    sd = load_checkpoint_dict(path)
    n = 2 if "premlp.2.weight" in sd else (1 if "premlp.0.weight" in sd
                                           else 0)
    p = FPNParams(premlp_layers=n)
    load_prefixed(p, sd, ("FeatureNet.",) + (("premlp.",) if n else ()))
    return p.to(device)


def fpn_features(p: nn.Module, img: torch.Tensor) -> List[torch.Tensor]:
    """[H, W, 3] (or [V, H, W, 3]) -> [raw, 8ch@1x, 16ch@1/2, 32ch@1/4],
    channel-last. `p` is a FeatureNet or a module holding one as
    `FeatureNet`."""
    net = getattr(p, "FeatureNet", p)
    batched = img.ndim == 4
    x = img.permute(0, 3, 1, 2) if batched else img.permute(2, 0, 1)[None]
    with f32_convs():
        x1 = net.conv0(x)
        x2 = net.conv1(x1)
        x3 = net.toplayer(net.conv2(x2))

    def cl(t):
        return t.permute(0, 2, 3, 1) if batched else from_cf(t)

    return [img, cl(x1), cl(x2), cl(x3)]


def premlp_embed(p: nn.Module, feats: torch.Tensor, colors: torch.Tensor,
                 dirs: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """[N, 56] feats + [N, 3] colours + [N, 3] dirs + [N, 1] conf ->
    [N, 32] through `p.premlp` (query_embedding's concat order,
    mvs_points_model.py:255-257)."""
    return p.premlp(torch.cat([feats, colors, dirs, conf], -1))


def random_fpn_checkpoint(path: str, seed: int = 0) -> str:
    """Write random FPN + two-layer premlp weights (`layers.random_` from
    a CPU generator seeded with `seed`) to `path` in `best_net_mvs.pth`'s
    layout (`FeatureNet.*`, `premlp.0.*`, `premlp.2.*`)."""
    from pointnerf2studio_torch.models.mvsnet.layers import random_
    p = random_(FPNParams(premlp_layers=2),
                torch.Generator().manual_seed(seed))
    torch.save(p.state_dict(), path)
    return path
