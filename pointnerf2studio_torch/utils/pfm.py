"""Portable Float Map (PFM) I/O.

A copy of the jax-free `pointnerf2studio_tpu/utils/pfm.py`. The
reference reads MVSNet-format depth maps from .pfm files
(mvs_utils.read_pfm:228-259); DTU GT depths ship in this format. PFM
is a 3-line ASCII header (``PF``/``Pf``, ``<width> <height>``, scale
with sign encoding endianness) followed by float32 rows stored
bottom-up.
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """-> float32 array [H, W] (``Pf``) or [H, W, 3] (``PF``),
    top-down row order."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(width * height * channels * 4),
                             dtype=dtype)
    if data.size != width * height * channels:
        raise ValueError(f"{path}: truncated PFM payload")
    img = data.reshape(height, width, channels)[::-1]   # bottom-up
    if abs(scale) not in (0.0, 1.0):
        img = img * abs(scale)
    return np.ascontiguousarray(
        img[..., 0] if channels == 1 else img).astype(np.float32)


def write_pfm(path: str, image: np.ndarray) -> None:
    """Write [H, W] or [H, W, 3] float data as little-endian PFM."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        header = b"Pf"
    elif img.ndim == 3 and img.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"PFM wants [H, W] or [H, W, 3]; got {img.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")                               # little-endian
        f.write(img[::-1].astype("<f4").tobytes())
