"""Neighbour-search geometry shared by the cache build and the render.

Port of `neighbor_offsets` from `pointnerf2studio_tpu/ops/query.py`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def neighbor_offsets(kernel_size: Tuple[int, int, int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Scan-ordered voxel offsets and their Chebyshev shell ids: shell 0
    first, then each shell's offsets in x-major order (the reference's
    layer/x/y/z loop nest, query_worldcoords.cu:256-263)."""
    num_layers = (kernel_size[0] + 1) // 2
    offs, shells = [], []
    for layer in range(num_layers):
        for x in range(-layer, layer + 1):
            for y in range(-layer, layer + 1):
                for z in range(-layer, layer + 1):
                    if max(abs(x), abs(y), abs(z)) != layer:
                        continue
                    offs.append((x, y, z))
                    shells.append(layer)
    return np.asarray(offs, np.int32), np.asarray(shells, np.int32)
