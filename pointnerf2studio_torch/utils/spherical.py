"""Real spherical-harmonics basis.

Port of `pointnerf2studio_tpu/utils/spherical.py`, for the `sh_intrp`
aggregation weight kernel: the standard real SH polynomials (graphics
convention, no Condon-Shortley phase) written out up to degree 5 (l = 0
to 4, 25 basis functions), band-major, in the input's dtype.
"""

from __future__ import annotations

import torch

MAX_TOTAL_DEG = 5  # l in [0, 4] -> up to 25 basis values


def sh_basis(dirs: torch.Tensor, total_deg: int) -> torch.Tensor:
    """The first total_deg ** 2 real SH basis values of unit directions
    dirs [..., 3] -> [..., total_deg ** 2] (l = 0; l = 1, m = -1..1; ...)."""
    if not 1 <= total_deg <= MAX_TOTAL_DEG:
        raise ValueError(f"total_deg must be in [1, {MAX_TOTAL_DEG}]")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if total_deg >= 2:
        c1 = 0.4886025119029199
        out += [c1 * y, c1 * z, c1 * x]
    if total_deg >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.31539156525252005 * (2.0 * zz - xx - yy),
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if total_deg >= 4:
        out += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (4.0 * zz - xx - yy),
            0.3731763325901154 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            0.4570457994644658 * x * (4.0 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    if total_deg >= 5:
        out += [
            2.5033429417967046 * xy * (xx - yy),
            1.7701307697799304 * yz * (3.0 * xx - yy),
            0.9461746957575601 * xy * (7.0 * zz - 1.0),
            0.6690465435572892 * yz * (7.0 * zz - 3.0),
            0.10578554691520431 * (35.0 * zz * zz - 30.0 * zz + 3.0),
            0.6690465435572892 * xz * (7.0 * zz - 3.0),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            1.7701307697799304 * xz * (xx - 3.0 * yy),
            0.6258357354491761 * (xx * (xx - 3.0 * yy)
                                  - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, -1)
