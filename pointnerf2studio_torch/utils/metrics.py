"""Image quality metrics: PSNR, SSIM, RMSE.

The port's own copy of `pointnerf2studio_tpu/utils/metrics.py`, which is
plain numpy (the reference's metric stack: torchmetrics PSNR, skimage
SSIM with an 11-wide uniform window, skimage RMSE; reference
pointnerf/nerfstudio/studio_model.py:40-53,433-464 and
pointnerf/run/evaluate.py:34-97). LPIPS needs pretrained feature nets
whose weights are not in the repo, and the port has no LPIPS network
yet (ROADMAP queue 1 item 11): `lpips()` raises RuntimeError, and
`compute_all` leaves it out, as the reference does without weights.
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


def lpips(img: np.ndarray, ref: np.ndarray, net: str = "alex") -> float:
    """LPIPS v0.1 (reference: run/evaluate.py:62-75). Not available in
    the port: raises RuntimeError, as the reference does without
    weights."""
    raise RuntimeError(
        f"LPIPS ({net}) needs pretrained weights, which the repo does not "
        f"hold, and the port has no LPIPS network yet (ROADMAP queue 1 "
        f"item 11)")


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
    PNG pairs, matched by sorted file name (reference
    pointnerf/run/evaluate.py:34-110). PIL is imported here, not at
    module import."""
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
    out["n_images"] = len(preds)
    return out
