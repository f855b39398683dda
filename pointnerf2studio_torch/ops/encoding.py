"""NeRF-style sinusoidal positional encodings.

Port of `pointnerf2studio_tpu/ops/encoding.py`: frequencies 2**i for
i in [0, F), channel-major, with the two reference layouts
(ori=False interleaves sin/cos per (channel, freq); ori=True lays out
[x, sin(all), cos(all)]) and the two evaluation modes ("direct" and
the angle-doubling recurrence "rec").
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int, ori: bool = False,
                        mode: str = "direct") -> torch.Tensor:
    """Sinusoidal encoding of `x` [..., C].

    Returns [..., C + 2*C*F] if ori else [..., 2*C*F], in x's dtype.
    "rec" evaluates sin/cos of the base octave in float32 and derives
    the higher octaves with sin(2a) = 2 sin(a) cos(a),
    cos(2a) = 1 - 2 sin(a)^2.
    """
    if num_freqs == 0:
        return x if ori else x.new_zeros(x.shape[:-1] + (0,))
    flat = x.shape[:-1] + (x.shape[-1] * num_freqs,)
    if mode == "rec":
        xf = x.float()
        s, c = torch.sin(xf), torch.cos(xf)
        sins, coss = [s], [c]
        for _ in range(num_freqs - 1):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            sins.append(s)
            coss.append(c)
        sin_flat = torch.stack(sins, -1).to(x.dtype).reshape(flat)
        cos_flat = torch.stack(coss, -1).to(x.dtype).reshape(flat)
    else:
        freqs = (2.0 ** torch.arange(num_freqs, device=x.device)).to(x.dtype)
        scaled = (x[..., None] * freqs).reshape(flat)
        sin_flat, cos_flat = torch.sin(scaled), torch.cos(scaled)
    if ori:
        return torch.cat([x, sin_flat, cos_flat], -1)
    return torch.stack([sin_flat, cos_flat], -1).reshape(
        flat[:-1] + (flat[-1] * 2,))
