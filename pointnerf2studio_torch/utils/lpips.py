"""LPIPS perceptual metric (alex and vgg variants).

Port of `pointnerf2studio_tpu/utils/lpips.py`, LPIPS v0.1 written with
F.conv2d and F.max_pool2d (torchvision is not needed):

    d(x, y) = sum_l mean_hw( || w_l * (phi_l(x)^ - phi_l(y)^) ||^2 )

where phi_l are AlexNet / VGG16 conv features tapped after each listed
ReLU, ^ is channel-unit normalisation, and w_l are the learned 1x1
linear weights (reference: pointnerf/run/evaluate.py:34-97, inputs scaled
to [-1, 1]).

Weights are not bundled. `load_torch_lpips_weights` imports a combined
torch state dict - the torchvision backbone's `features.<i>.*` tensors
and the lpips package's `lin<l>.model.1.weight` heads - which the JAX
package's `EXPORT_SNIPPET` writes on a machine that has those packages.
`init_random_params` draws a tree from numpy with the reference's draws,
so one seed gives both packages the same weights (structure tests and
smoke runs only: not a perceptual metric). A parameter tree is {"convs":
[{"w": [O, I, kh, kw], "b": [O]}], "lins": [[C_l]], "net": name}, the
tensors on one device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pointnerf2studio_torch.models.mvsnet.layers import f32_convs
from pointnerf2studio_torch.ops._cuda import resolve_device

# (kind, out_channels, kernel, stride, padding) conv stacks; "pool" is a
# k x k / s max-pool. Feature taps are taken after each listed ReLU.
_ALEX_CFG = [  # torchvision AlexNet.features
    ("conv", 64, 11, 4, 2), ("relu",), ("pool", 3, 2),
    ("conv", 192, 5, 1, 2), ("relu",), ("pool", 3, 2),
    ("conv", 384, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
]
_ALEX_TAPS = (1, 4, 7, 9, 11)          # indices (after relu) in _ALEX_CFG
_ALEX_CHANNELS = (64, 192, 384, 256, 256)

_VGG_CFG = [  # torchvision VGG16.features (through conv5_3)
    ("conv", 64, 3, 1, 1), ("relu",), ("conv", 64, 3, 1, 1), ("relu",),
    ("pool", 2, 2),
    ("conv", 128, 3, 1, 1), ("relu",), ("conv", 128, 3, 1, 1), ("relu",),
    ("pool", 2, 2),
    ("conv", 256, 3, 1, 1), ("relu",), ("conv", 256, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
    ("pool", 2, 2),
    ("conv", 512, 3, 1, 1), ("relu",), ("conv", 512, 3, 1, 1), ("relu",),
    ("conv", 512, 3, 1, 1), ("relu",),
    ("pool", 2, 2),
    ("conv", 512, 3, 1, 1), ("relu",), ("conv", 512, 3, 1, 1), ("relu",),
    ("conv", 512, 3, 1, 1), ("relu",),
]
_VGG_TAPS = (3, 8, 15, 22, 29)
_VGG_CHANNELS = (64, 128, 256, 512, 512)

# lpips ScalingLayer constants (lpips/lpips.py v0.1)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

CONFIGS = {"alex": (_ALEX_CFG, _ALEX_TAPS, _ALEX_CHANNELS),
           "vgg": (_VGG_CFG, _VGG_TAPS, _VGG_CHANNELS)}


def _tree(convs, lins, net, device) -> Dict:
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    return {"convs": [{"w": t(c["w"]), "b": t(c["b"])} for c in convs],
            "lins": [t(w) for w in lins], "net": net}


def init_random_params(net: str = "alex", seed: int = 0,
                       device: torch.device | str | None = None) -> Dict:
    """A random-weight tree on `device` (None: the card): the reference's
    numpy draws in its order (conv weights normal(0, 0.1) drawn as [kh,
    kw, I, O], zero biases, heads |normal(0, 0.01)|), so the same seed
    gives the JAX package's tree."""
    device = resolve_device(device)
    cfg, _, chans = CONFIGS[net]
    rng = np.random.default_rng(seed)
    convs: List[Dict[str, np.ndarray]] = []
    c_in = 3
    for item in cfg:
        if item[0] == "conv":
            c_out, k = item[1], item[2]
            w = rng.normal(0, 0.1, (k, k, c_in, c_out)).astype(np.float32)
            convs.append({"w": w.transpose(3, 2, 0, 1),
                          "b": np.zeros((c_out,), np.float32)})
            c_in = c_out
    lins = [np.abs(rng.normal(0, 0.01, (c,))).astype(np.float32)
            for c in chans]
    return _tree(convs, lins, net, device)


def _features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """x: [N, 3, H, W] in [-1, 1] -> the tapped feature maps (NCHW)."""
    cfg, taps, _ = CONFIGS[params["net"]]
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    feats = []
    ci = 0
    with f32_convs():
        for i, item in enumerate(cfg):
            if item[0] == "conv":
                c = params["convs"][ci]
                ci += 1
                x = F.conv2d(x, c["w"], c["b"], stride=item[3],
                             padding=item[4])
            elif item[0] == "relu":
                x = F.relu(x)
                if i in taps:
                    feats.append(x)
            else:
                x = F.max_pool2d(x, item[1], item[2])
    return feats


def lpips_distance(params: Dict, img, gt) -> torch.Tensor:
    """LPIPS between two [H, W, 3] images in [0, 1] (tensors or arrays;
    evaluate.py scales them to [-1, 1] before the net), on the device of
    the weights."""
    dev = params["lins"][0].device

    def prep(a):
        a = torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
            a, torch.Tensor) else a, dtype=torch.float32, device=dev)
        return a.permute(2, 0, 1)[None] * 2.0 - 1.0

    fx = _features(params, prep(img))
    fy = _features(params, prep(gt))
    total = torch.zeros((), device=dev)
    for f1, f2, w in zip(fx, fy, params["lins"]):
        n1 = f1 / torch.sqrt((f1 ** 2).sum(1, keepdim=True) + 1e-10)
        n2 = f2 / torch.sqrt((f2 ** 2).sum(1, keepdim=True) + 1e-10)
        d = (n1 - n2) ** 2 * w.view(1, -1, 1, 1)   # 1x1 conv = channel scale
        total = total + d.sum(1).mean()
    return total


def load_torch_lpips_weights(path: str,
                             device: torch.device | str | None = None
                             ) -> Dict:
    """Import a combined torch state dict: the torchvision backbone
    (`features.<i>.weight/bias`, OIHW) + the lpips heads
    (`lin<l>.model.1.weight`, [1, C, 1, 1], negative values clipped to 0
    as the reference does)."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = sd.get("net", "alex")
    if hasattr(net, "item"):
        net = str(net)
    cfg, _, chans = CONFIGS[net]
    convs = []
    for i, it in enumerate(cfg):   # torchvision indexes the same layers
        if it[0] == "conv":
            convs.append({"w": sd[f"features.{i}.weight"].numpy(),
                          "b": sd[f"features.{i}.bias"].numpy()})
    lins = [np.maximum(sd[f"lin{l}.model.1.weight"].numpy().reshape(c), 0.0)
            for l, c in enumerate(chans)]
    return _tree(convs, lins, net, device)


def find_weights(net: str = "alex") -> Optional[str]:
    """A combined weight file `lpips_<net>_combined.pth` in
    $LPIPS_WEIGHTS_DIR or ~/.cache/pointnerf2studio_torch, else None."""
    for d in (os.environ.get("LPIPS_WEIGHTS_DIR", ""),
              os.path.expanduser("~/.cache/pointnerf2studio_torch")):
        if not d:
            continue
        p = os.path.join(d, f"lpips_{net}_combined.pth")
        if os.path.exists(p):
            return p
    return None
