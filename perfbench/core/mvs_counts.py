"""The joint MVS step's arithmetic: the operations of its networks and
the bytes of its cost-volume build, from the layer shapes of the
benchmark's reference (`perfbench/reference/mvs.py`) on a cell's inputs,
never from the program. The render's operations are `counts.py`'s
(`row_flops`, `slot_flops`) on the reference's own rows and slots."""

from __future__ import annotations

from perfbench.reference.mvs import FPN, UNET_DOWN, UNET_UP


def _conv(cin: int, cout: int, taps: int, outputs: int) -> int:
    """Operations of a convolution: a multiply-add (2 operations) for each
    input channel, tap and output channel of each output position."""
    return 2 * cin * cout * taps * outputs


def fpn_flops(H: int, W: int) -> int:
    """FeatureNet over one H x W view: its eight convolutions and the
    toplayer."""
    total, h, w = 0, H, W
    for _, layers in FPN:
        for ci, co, k, s, _ in layers:
            h, w = h // s, w // s
            total += _conv(ci, co, k * k, h * w)
    return total + _conv(32, 32, 1, h * w)


def costreg_flops(cin: int, D: int, h: int, w: int) -> int:
    """CostRegNet and ProbNet over a [cin, D, h, w] volume: each 3x3x3
    convolution at its output positions, each transposed stage at its
    input positions (every input position meets 27 taps)."""
    total, n = 0, D * h * w
    for _, ci, co, s in UNET_DOWN:
        n //= s ** 3
        total += _conv(ci or cin, co, 27, n)
    for _, ci, co in UNET_UP:
        total += _conv(ci, co, 27, n)
        n *= 8
    return total + _conv(8, 1, 27, n)


def mvs_flops(cfg: dict) -> int:
    """Forward operations of one joint step's MVS networks: FeatureNet
    over every view, CostRegNet and ProbNet over the cost volume, the
    premlp over every generated point."""
    m, cam = cfg["mvs"], cfg["camera"]
    V, H, W = m["num_views"], cam["height"], cam["width"]
    h, w = H // 4, W // 4
    premlp = _conv(63, 32, 1, h * w) + (m["premlp_layers"] - 1) \
        * _conv(32, 32, 1, h * w)
    return (V * fpn_flops(H, W)
            + costreg_flops(3 * V + 32, m["num_depth"], h, w) + premlp)


def costvol_bytes(cfg: dict) -> int:
    """Bytes the forward cost-volume build needs at least: the [D, h, w,
    3V + 32] float32 volume written once, and every view's 1/4-resolution
    features (32) and colours (3) read once."""
    m, cam = cfg["mvs"], cfg["camera"]
    V = m["num_views"]
    hw = (cam["height"] // 4) * (cam["width"] // 4)
    return 4 * hw * (m["num_depth"] * (3 * V + 32) + V * 35)
