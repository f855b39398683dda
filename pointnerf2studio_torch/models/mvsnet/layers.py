"""Conv/BN building blocks of the MVS networks.

Port of `pointnerf2studio_tpu/models/mvsnet/layers.py`. The modules keep
the reference's torch state-dict names (`<name>.conv.weight`,
`<name>.bn.{weight,bias,running_mean,running_var,num_batches_tracked}`),
so a checkpoint loads with `load_state_dict(strict=True)`.

BatchNorm is applied with its stored statistics, always: the reference's
point generation runs the networks frozen, and its joint step trains the
statistics as parameters (the JAX tree holds `mean` and `var` beside
`scale` and `bias`, and every leaf gets an Adam update) but never
re-estimates them from a batch. `BatchNorm` here therefore holds all four
as parameters and has no training mode; it computes `(x - mean) *
rsqrt(var + eps) * weight + bias` in the reference's order of operations.

Convolutions run channel-first (torch NCHW / NCDHW). The functions of the
reference's API take and return its channel-last arrays ([H, W, C],
[D, H, W, C]) and permute at their edges. On the card they run in full
float32 and with cuDNN's deterministic algorithms: `f32_convs()` turns
TF32 off around them, since the depth net's 0.8 confidence gate and its
truncated expectation index are decided on the float edge, and asks for
the same bits on every run: CostRegNet's 3-D convolutions otherwise give
other last bits from run to run, which move generated points across the
image border and, now and then, change the joint step's loss.

`bilinear_grid_sample` is the reference's four-tap sampler, written tap by
tap as there and not with F.grid_sample, whose edge handling and rounding
differ; the plane background model (`models/bg_plane.py`) uses it too.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


@contextlib.contextmanager
def f32_convs():
    """cuDNN convolutions without TF32 and with deterministic algorithms
    inside the block (a no-op off the card)."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False, deterministic=True):
        yield


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1 with stored statistics (see the module
    docstring); the state-dict names of nn.BatchNorm*."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


class ConvBn(nn.Module):
    """Conv (no bias) + BatchNorm, optionally ReLU: the reference's
    ConvBnReLU / ConvBnReLU3D (`relu=False` where its forward has none)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 pad: int = 1, relu: bool = True, three_d: bool = False):
        super().__init__()
        conv = nn.Conv3d if three_d else nn.Conv2d
        self.conv = conv(cin, cout, k, stride=stride, padding=pad,
                         bias=False)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class ConvTransposeBn(nn.Sequential):
    """ConvTranspose3d(k 3, stride 2, padding 1, output_padding 1, no
    bias) + BatchNorm (+ ReLU): the reference's `nn.Sequential` of the
    cost-regularisation U-Net, state-dict names `0.weight` and `1.*`."""

    def __init__(self, cin: int, cout: int, relu: bool = True):
        layers = [nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                     output_padding=1, bias=False),
                  BatchNorm(cout)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


def random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `module` in place with random values from
    `generator` (a CPU generator), in `named_parameters` order: conv and
    linear weights normal with variance 1 / (the elements of one output
    row), so that a stack without ReLU keeps its scale, BatchNorm scales
    and variances uniform in [0.5, 1.5), biases and means normal(0, 0.1).
    Random reference-layout weights for tests and smoke runs; not a
    trained network."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim > 1:
                v = torch.randn(p.shape, generator=generator) * (
                    1.0 / p[0].numel()) ** 0.5
            elif leaf in ("weight", "running_var"):
                v = 0.5 + torch.rand(p.shape, generator=generator)
            else:
                v = 0.1 * torch.randn(p.shape, generator=generator)
            p.copy_(v.to(p.device))
    return module


def to_cf(x: torch.Tensor) -> torch.Tensor:
    """[..., C] channel-last without batch -> [1, C, ...]."""
    return x.movedim(-1, 0)[None]


def from_cf(x: torch.Tensor) -> torch.Tensor:
    """[1, C, ...] -> [..., C]."""
    return x[0].movedim(0, -1)


def edge_pad8(x: torch.Tensor) -> torch.Tensor:
    """[1, C, D, H, W] edge-padded at the end of each spatial axis up to a
    multiple of 8 (the reference's `jnp.pad(mode="edge")`, so that the
    three stride-2 levels of the U-Net add back onto their skips)."""
    pads = []
    for n in reversed(x.shape[2:]):
        pads += [0, (-n) % 8]
    return F.pad(x, pads, mode="replicate") if any(pads) else x


def bilinear_grid_sample(img: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear sampling with zero padding for an [H, W, C] image at
    normalised coordinates grid [..., 2] in [-1, 1] (x, the width axis,
    first) -> [..., C]: four taps, each outside the image contributing
    zero (torch's F.grid_sample(mode="bilinear", padding_mode="zeros")
    semantics)."""
    H, W, _ = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = x0.long()
    y0i = y0.long()

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return v * inb[..., None].to(img.dtype)

    return (tap(x0i, y0i) * ((1 - wx) * (1 - wy))[..., None]
            + tap(x0i + 1, y0i) * (wx * (1 - wy))[..., None]
            + tap(x0i, y0i + 1) * ((1 - wx) * wy)[..., None]
            + tap(x0i + 1, y0i + 1) * (wx * wy)[..., None])


def load_checkpoint_dict(path: str, strip: str = "") -> dict:
    """A torch checkpoint's state dict (under a "model" key where it has
    one; a module's state_dict where it is a module), with `strip` removed
    from every key, on the CPU."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(ck, "state_dict"):
        ck = ck.state_dict()
    sd = ck.get("model", ck) if isinstance(ck, dict) else ck
    return {k.replace(strip, "") if strip else k: v for k, v in sd.items()}


def load_prefixed(module: nn.Module, sd: dict,
                  prefixes: Sequence[str]) -> nn.Module:
    """Load the keys of `sd` that start with one of `prefixes` into
    `module` with strict=True; num_batches_tracked, which BatchNorm keeps
    but never reads, may be absent."""
    sub = {k: v for k, v in sd.items() if k.startswith(tuple(prefixes))}
    own = module.state_dict()
    for k in own:
        if k.endswith("num_batches_tracked") and k not in sub:
            sub[k] = own[k]
    with torch.no_grad():
        module.load_state_dict(sub, strict=True)
    return module
