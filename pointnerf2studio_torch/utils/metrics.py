"""Image quality metrics: PSNR, SSIM, RMSE.

The port's own copy of `pointnerf2studio_tpu/utils/metrics.py`, which is
plain numpy (the reference's metric stack: torchmetrics PSNR, skimage
SSIM with an 11-wide uniform window, skimage RMSE; reference
pointnerf/nerfstudio/studio_model.py:40-53,433-464 and
pointnerf/run/evaluate.py:34-97), and LPIPS through `utils/lpips.py`
with a combined weight file (`weights_path`, or one that
`lpips.find_weights` finds). The repo holds no LPIPS weights: without a
file `lpips()` raises RuntimeError, where the reference would try the
torch `lpips` package (installed on neither of the machines the port
runs on), and `compute_all` and `metrics_over_dirs` leave it out.
"""

from __future__ import annotations

import numpy as np


def psnr(img: np.ndarray, ref: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((np.asarray(img, np.float64)
                   - np.asarray(ref, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def rmse(img: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean(
        (np.asarray(img, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with window `size` over the first two axes ('valid')."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2))
    s = (c[size:, size:] - c[:-size, size:] - c[size:, :-size]
         + c[:-size, :-size])
    return s / (size * size)


def ssim(img: np.ndarray, ref: np.ndarray, data_range: float = 1.0,
         win_size: int = 11) -> float:
    """Structural similarity with skimage's settings: a uniform window,
    per channel then averaged, sample covariance (N / (N - 1))."""
    x = np.asarray(img, np.float64)
    y = np.asarray(ref, np.float64)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)
    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + C1) * (2 * vxy + C2)
         / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)))
    # the valid region is already skimage's cropped map
    return float(s.mean())


_LPIPS_CACHE: dict = {}


def lpips(img: np.ndarray, ref: np.ndarray, net: str = "alex",
          weights_path: str | None = None, device=None) -> float:
    """LPIPS v0.1 of two [H, W, 3] images in [0, 1] (reference:
    run/evaluate.py:62-75, lpips-alex and lpips-vgg on [-1, 1] inputs) on
    `device` (None: the card), with the weights of `weights_path` or of
    `lpips.find_weights(net)`; RuntimeError without a weight file."""
    from pointnerf2studio_torch.ops._cuda import resolve_device
    from pointnerf2studio_torch.utils import lpips as lp

    path = weights_path or lp.find_weights(net)
    if path is None:
        raise RuntimeError(
            f"LPIPS ({net}) needs a combined weight file (the JAX "
            f"package's utils/lpips.py EXPORT_SNIPPET writes one); none "
            f"was given or found in $LPIPS_WEIGHTS_DIR")
    dev = resolve_device(device)
    key = (net, path, str(dev))
    if key not in _LPIPS_CACHE:
        _LPIPS_CACHE[key] = lp.load_torch_lpips_weights(path, device=dev)
    return float(lp.lpips_distance(_LPIPS_CACHE[key], img, ref))


def compute_all(img: np.ndarray, ref: np.ndarray) -> dict:
    out = {"psnr": psnr(img, ref), "ssim": ssim(img, ref),
           "rmse": rmse(img, ref)}
    try:
        out["lpips"] = lpips(img, ref, net="alex")
        out["vgglpips"] = lpips(img, ref, net="vgg")
    except RuntimeError:
        pass    # no weights: PSNR/SSIM/RMSE only
    return out


def metrics_over_dirs(pred_dir: str, gt_dir: str,
                      pattern: str = "*.png") -> dict:
    """PSNR / SSIM / RMSE over two directories of rendered and ground-truth
    PNG pairs, matched by sorted file name, and LPIPS where `lpips` finds
    a weight file (reference pointnerf/run/evaluate.py:34-110). PIL is
    imported here, not at module import."""
    import glob
    import os

    from PIL import Image

    preds = sorted(glob.glob(os.path.join(pred_dir, pattern)))
    gts = sorted(glob.glob(os.path.join(gt_dir, pattern)))
    if not preds or len(preds) != len(gts):
        raise ValueError(
            f"mismatched image sets: {len(preds)} vs {len(gts)}")

    def load(path):
        return np.asarray(Image.open(path), np.float32)[..., :3] / 255.0

    acc = {"psnr": [], "ssim": [], "rmse": []}
    for p, g in zip(preds, gts):
        a, b = load(p), load(g)
        acc["psnr"].append(psnr(a, b))
        acc["ssim"].append(ssim(a, b))
        acc["rmse"].append(rmse(a, b))
    out = {k: float(np.mean(v)) for k, v in acc.items()}
    try:
        out["lpips"] = float(np.mean([lpips(load(p), load(g))
                                      for p, g in zip(preds, gts)]))
    except RuntimeError:
        pass
    out["n_images"] = len(preds)
    return out
