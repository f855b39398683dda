"""Block-layout positional encodings and the matching weight permutation.

Port of the helpers `_pe_blocks` and `_w1_permutation` of
`pointnerf2studio_tpu/ops/fused_decode.py`. The fused kernels lay a
positional encoding out as channel blocks, [sin(x*2^0), ..,
sin(x*2^{F-1}), cos(x*2^0), ..], a permutation of the reference's
interleaved layout (ops/encoding.py) that the first-layer weight rows
absorb once. The decode kernels of that module are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def _pe_blocks(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Block-layout PE of x [..., C]: sins then coss, each [..., C] per
    octave; evaluated in float32, returned in x's dtype."""
    xf = x.float()
    sins = [torch.sin(xf * (2.0 ** j)) for j in range(num_freqs)]
    coss = [torch.cos(xf * (2.0 ** j)) for j in range(num_freqs)]
    return torch.cat(sins + coss, -1).to(x.dtype)


def _w1_permutation(c: int, feat_freqs: int, d: int, dist_freqs: int
                    ) -> np.ndarray:
    """`perm` with W1_kernel = W1_ref[perm]: the block PE layout of
    [emb, PE(emb), PE(dists)] onto the reference interleaved layout,
    where channel i, freq j sits at base + (i*F + j)*2 + (0 sin | 1 cos)."""
    perm = list(range(c))
    base = c
    for sc in (0, 1):
        for j in range(feat_freqs):
            for i in range(c):
                perm.append(base + (i * feat_freqs + j) * 2 + sc)
    base = c + 2 * c * feat_freqs
    for sc in (0, 1):
        for j in range(dist_freqs):
            for i in range(d):
                perm.append(base + (i * dist_freqs + j) * 2 + sc)
    return np.asarray(perm, np.int64)
