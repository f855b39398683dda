"""The whole post-gather chunk of the fast render path in one pass.

Port of `pointnerf2studio_tpu/ops/fused_chunk.py`. Per shading slot:
candidate selection (d2 from the bf16 relative xyz, validity / radius /
layered-shell masks, the K smallest d2 with smallest-index tie-break),
payload extract, linear inverse-distance weights normalised over K,
Rw2c-rotated dists plus w2pers offsets, the per-neighbour tower with
weighted alpha/feature sums over K, and the colour tower on the
aggregate plus PE(viewdir). Output: (sigma, rgb, found) per slot.

`fused_chunk_decode` is the wrapper of the hand-written CUDA kernel
`csrc/fused_chunk.cu` (replacing the Pallas kernel `_kernel`,
ops/fused_chunk.py:86 of the reference). On CUDA tensors it launches the
kernel; on CPU tensors it runs the plain version
`fused_chunk_decode_reference`, which mirrors the Pallas kernel op for
op. Both read the candidate rows through `qslot` from the kernel-facing
cache (kmeta [max_q, C] int32, kpay [max_q, PK, C] bf16); the plain
version gathers them explicitly, the kernel reads them in place.

The kernel is bound by its tensor-core products and by the weight
fragments it streams from L2, not by the candidate bytes; its source
header says how. Slots whose mask is false output (0, 0, False).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops.fused_decode import _pe_blocks, _w1_permutation

PK = 48                 # payload channels (PAYW = 44 padded to 48)
FEAT = 32               # embedding width the cache payload fixes
PLAIN_BLOCK = 16384     # slots per step of the plain version (memory bound)


def fused_chunk_eligible(cfg: AggregatorConfig, per_point_rw2c: bool,
                         K: int) -> bool:
    """The configurations the fused chunk implements (the reference's
    gate, unchanged)."""
    return (not per_point_rw2c
            and cfg.agg_intrp_order == 2
            and cfg.agg_distance_kernel == "linear"
            and cfg.agg_weight_norm
            and not cfg.conf_in_weight
            and tuple(cfg.axis_weight) == (1.0, 1.0, 1.0)
            and cfg.point_color_mode and cfg.point_dir_mode
            and cfg.num_mlp_base_layers == 2
            and cfg.num_mlp_head_layers == 2
            and cfg.dist_dim == 6
            and cfg.point_features_dim == 32
            and cfg.shading_feature_dim == cfg.point_features_dim
            and cfg.compute_dtype == "bfloat16")


def _dirpe_permutation(F: int) -> np.ndarray:
    """Rows mapping block-layout PE(viewdirs) (sans raw dirs) onto the
    reference interleaved layout: channel i, freq j at (i*F + j)*2 + sc."""
    perm = []
    for sc in (0, 1):
        for j in range(F):
            for i in range(3):
                perm.append((i * F + j) * 2 + sc)
    return np.asarray(perm, np.int64)


@torch.no_grad()
def _prep_params(agg: Aggregator, C: int, nff: int, ndf: int, nvf: int):
    """Split/permute the weights for the block-PE, concat-free tower.

    Returns ((w1a, w1b, w1c, b1, w2, b2, w3a, w3b, b3, w4, b4, wd, bd,
    wc0a, wc0b, bc0, [wc_i, bc_i]..., wch, bch), n_color_rest): kernels
    [in, out] bf16, biases [1, out] float32 — the reference's layout."""
    bf = torch.bfloat16

    def kern(lin):
        return lin.weight.T

    def wb(lin):
        return kern(lin).to(bf), lin.bias[None, :].float()

    dev = agg.mlp_base[0].weight.device
    perm = torch.as_tensor(_w1_permutation(C, nff, 6, ndf), device=dev)
    w1 = kern(agg.mlp_base[0])[perm].to(bf)
    nf, nd = 2 * C * nff, 2 * 6 * ndf
    w1a, w1b, w1c = w1[:C], w1[C:C + nf], w1[C + nf:C + nf + nd]
    b1 = agg.mlp_base[0].bias[None, :].float()
    w2, b2 = wb(agg.mlp_base[1])
    w3, b3 = wb(agg.mlp_head[0])
    w3a, w3b = w3[:w2.shape[1]], w3[w2.shape[1]:]
    w4, b4 = wb(agg.mlp_head[1])
    wd, bd = wb(agg.density_head[0])
    c0 = kern(agg.mlp_color[0])
    hidden = w4.shape[1]
    dperm = torch.as_tensor(hidden + _dirpe_permutation(nvf), device=dev)
    wc0a = c0[:hidden].to(bf)
    wc0b = c0[dperm].to(bf)
    bc0 = agg.mlp_color[0].bias[None, :].float()
    rest: List[torch.Tensor] = []
    for lin in agg.mlp_color[1:]:
        rest.extend(wb(lin))
    wch, bch = wb(agg.color_head[0])
    return ((w1a, w1b, w1c, b1, w2, b2, w3a, w3b, b3, w4, b4, wd, bd,
             wc0a, wc0b, bc0) + tuple(rest) + (wch, bch),
            len(agg.mlp_color) - 1)


def _kernel_params(plist, n_color_rest: int) -> torch.Tensor:
    """Pack the prepped weights into the kernel's one bf16 buffer:
    [in, out] row-major blocks in csrc/fused_chunk.cu's order, the input
    rows padded to 16 and the 1- and 3-wide heads to 16 columns, each
    bias (rounded to bf16, as the reference's kernel rounds it) after
    its matrix."""
    (w1a, w1b, w1c, b1, w2, b2, w3a, w3b, b3, w4, b4, wd, bd,
     wc0a, wc0b, bc0) = plist[:16]
    if n_color_rest != 2 or w2.shape != (256, 256) or wc0a.shape[1] != 128:
        raise ValueError("the CUDA fused chunk kernel is built for hidden "
                         "256, colour width 128 and 3 colour layers")
    rest = plist[16:16 + 2 * n_color_rest]
    wch, bch = plist[-2:]
    bf = torch.bfloat16

    def padm(w, rows, cols):
        out = w.new_zeros((rows, cols), dtype=bf)
        out[:w.shape[0], :w.shape[1]] = w.to(bf)
        return out.reshape(-1)

    def padb(b, cols):
        out = b.new_zeros((cols,), dtype=bf)
        out[:b.shape[-1]] = b.reshape(-1).to(bf)
        return out

    parts = [padm(torch.cat([w1a, w1b, w1c]), 288, 256), padb(b1, 256),
             padm(w2, 256, 256), padb(b2, 256),
             padm(torch.cat([w3a, w3b]), 272, 256), padb(b3, 256),
             padm(w4, 256, 256), padb(b4, 256),
             padm(wd, 256, 16), padb(bd, 16),
             padm(torch.cat([wc0a, wc0b]), 288, 128), padb(bc0, 128),
             padm(rest[0], 128, 128), padb(rest[1], 128),
             padm(rest[2], 128, 128), padb(rest[3], 128),
             padm(wch, 128, 16), padb(bch, 16)]
    return torch.cat(parts).contiguous()


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.1 * x)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product accumulated in float32."""
    return x.to(torch.bfloat16).float() @ w.float()


def _bias_act(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """leaky((bf16(x) + bf16(b)) in bf16, then float32)."""
    return _leaky((x.to(torch.bfloat16) + b.to(torch.bfloat16)).float())


def _decode_block(plist, n_color_rest, Rw2c, camrotc2w, campos, meta, pay,
                  locs, center, rd, mask, K, radius2, num_shells, nff, ndf,
                  nvf, act_super):
    """One block of B slots, the reference kernel's math op for op.
    meta [B, C] int32, pay [B, PK, C] bf16; returns (sig, rgb, found)."""
    (w1a, w1b, w1c, b1, w2, b2, w3a, w3b, b3, w4, b4, wd, bd,
     wc0a, wc0b, bc0) = plist[:16]
    color_rest = plist[16:16 + 2 * n_color_rest]
    wch, bch = plist[-2:]
    f32 = torch.float32
    B, C = meta.shape
    shell = meta & 3
    valid = (meta >= 0) & mask[:, None]
    cam = [campos[i] for i in range(3)]
    R = [[camrotc2w[r, i] for i in range(3)] for r in range(3)]
    W = [[Rw2c[r, i] for i in range(3)] for r in range(3)]
    loc = [locs[:, i] for i in range(3)]
    cen = [center[:, i] for i in range(3)]
    rdv = [rd[:, i] for i in range(3)]

    px, py, pz = (pay[:, i, :].float() for i in range(3))
    dx = px + (cen[0] - loc[0])[:, None]
    dy = py + (cen[1] - loc[1])[:, None]
    dz = pz + (cen[2] - loc[2])[:, None]
    d2 = dx * dx + dy * dy + dz * dz
    ok = valid
    if radius2 > 0:
        ok = ok & (d2 <= radius2)
    if num_shells > 1:
        eligible = shell == 0
        before = torch.zeros((B, 1), dtype=torch.int32, device=meta.device)
        for s in range(1, num_shells):
            before = before + (ok & (shell == s - 1)).sum(
                -1, keepdim=True, dtype=torch.int32)
            eligible = eligible | ((shell == s) & (before < K))
        ok = ok & eligible

    inf = torch.tensor(float("inf"), device=meta.device)
    key = torch.where(ok, d2, inf)
    col = torch.arange(C, device=meta.device).expand(B, C)
    pays, masks, wraw, dwork = [], [], [], []
    wsum = torch.zeros(B, dtype=f32, device=meta.device)
    for _ in range(K):
        m = key.min(-1, keepdim=True).values
        first = torch.where(key == m, col, C).min(-1, keepdim=True).values
        pm = m[:, 0] < inf
        sel = (col == first) & pm[:, None]
        pv = torch.gather(pay, 2, torch.clamp(first, max=C - 1)[:, None, :]
                          .expand(B, PK, 1))[..., 0].float()
        pv = pv * pm[:, None].to(f32)
        key = torch.where(sel, inf, key)
        nx = [pv[:, i] + cen[i] for i in range(3)]
        dw = [nx[i] - loc[i] for i in range(3)]
        dn = torch.sqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
        w = pm.to(f32) / torch.clamp(dn, min=1e-6)
        pays.append(pv)
        masks.append(pm)
        wraw.append(w)
        dwork.append((nx, dw))
        wsum = wsum + w
    wnorm = 1.0 / torch.clamp(wsum, min=1e-8)

    vd = [rdv[0] * W[0][j] + rdv[1] * W[1][j] + rdv[2] * W[2][j]
          for j in range(3)]
    ls = [loc[i] - cam[i] for i in range(3)]
    lc = [ls[0] * R[0][j] + ls[1] * R[1][j] + ls[2] * R[2][j]
          for j in range(3)]
    lpx, lpy = lc[0] / lc[2], lc[1] / lc[2]

    aw_sum = torch.zeros((B, 1), dtype=f32, device=meta.device)
    hw_sum = None
    found = torch.zeros(B, dtype=torch.bool, device=meta.device)
    for k in range(K):
        pv, pm = pays[k], masks[k]
        nx, dw = dwork[k]
        emb = pv[:, 3:3 + FEAT].to(torch.bfloat16)
        ncol, ndir = pv[:, 39:42], pv[:, 36:39]
        ns = [nx[i] - cam[i] for i in range(3)]
        nc = [ns[0] * R[0][j] + ns[1] * R[1][j] + ns[2] * R[2][j]
              for j in range(3)]
        npx, npy = nc[0] / nc[2], nc[1] / nc[2]
        pd = [npx * nc[2] - lpx * lc[2], npy * nc[2] - lpy * lc[2],
              nc[2] - lc[2]]
        dr = [dw[0] * W[0][j] + dw[1] * W[1][j] + dw[2] * W[2][j]
              for j in range(3)]
        dists_rot = torch.stack(dr + pd, -1).to(torch.bfloat16)

        x = (_mm(emb, w1a) + _mm(_pe_blocks(emb, nff), w1b)
             + _mm(_pe_blocks(dists_rot, ndf), w1c))
        x = _bias_act(x, b1)
        x = _bias_act(_mm(x, w2), b2)
        ndr = [ndir[:, 0] * W[0][j] + ndir[:, 1] * W[1][j]
               + ndir[:, 2] * W[2][j] for j in range(3)]
        dirdot = torch.stack(
            [ndr[0] - vd[0], ndr[1] - vd[1], ndr[2] - vd[2],
             ndr[0] * vd[0] + ndr[1] * vd[1] + ndr[2] * vd[2]], -1)
        cd = torch.cat([ncol, dirdot], -1).to(torch.bfloat16)
        h = _bias_act(_mm(x, w3a) + _mm(cd, w3b), b3)
        h = _bias_act(_mm(h, w4), b4)
        raw = (_mm(h, wd).to(torch.bfloat16)
               + bd.to(torch.bfloat16)).float()
        alpha = (torch.nn.functional.softplus(raw - 1.0) if act_super
                 else torch.clamp(raw, min=0.0))
        wk = (wraw[k] * wnorm)[:, None]
        aw_sum = aw_sum + alpha * wk
        hk = h * wk
        hw_sum = hk if hw_sum is None else hw_sum + hk
        found = found | pm

    x = _mm(hw_sum, wc0a) + _mm(
        _pe_blocks(torch.stack(vd, -1).to(torch.bfloat16), nvf), wc0b)
    x = _bias_act(x, bc0)
    for i in range(n_color_rest):
        x = _bias_act(_mm(x, color_rest[2 * i]), color_rest[2 * i + 1])
    raw_rgb = (_mm(x, wch).to(torch.bfloat16)
               + bch.to(torch.bfloat16)).float()
    rgb = torch.sigmoid(raw_rgb) * (1 + 2e-3) - 1e-3
    keep = mask.to(f32)
    return aw_sum[:, 0] * keep, rgb * keep[:, None], found


@torch.no_grad()
def fused_chunk_decode_reference(
    params: Aggregator, Rw2c, camrotc2w, campos, kmeta, kpay, qslot, locs,
    center, rd, mask, *, K: int, radius2: float, num_shells: int,
    nff: int, ndf: int, nvf: int, act_super: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `fused_chunk_decode`: gathers kmeta[qslot] and
    kpay[qslot] explicitly and runs the reference kernel's math in
    blocks of PLAIN_BLOCK slots."""
    block = PLAIN_BLOCK
    plist, n_rest = _prep_params(params, FEAT, nff, ndf, nvf)
    outs = []
    for s in range(0, qslot.shape[0], block):
        q = qslot[s:s + block].long()
        outs.append(_decode_block(
            plist, n_rest, Rw2c.float(), camrotc2w.float(), campos.float(),
            kmeta[q], kpay[q], locs[s:s + block].float(),
            center[s:s + block].float(), rd[s:s + block].float(),
            mask[s:s + block], K, radius2, num_shells, nff, ndf, nvf,
            act_super))
    if not outs:
        dev = qslot.device
        return (torch.zeros(0, device=dev), torch.zeros(0, 3, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return tuple(torch.cat(x) for x in zip(*outs))


@torch.no_grad()
def fused_chunk_decode(
    params: Aggregator,
    Rw2c: torch.Tensor,         # [3, 3]
    camrotc2w: torch.Tensor,    # [3, 3]
    campos: torch.Tensor,       # [3]
    kmeta: torch.Tensor,        # [max_q, C] int32
    kpay: torch.Tensor,         # [max_q, PK, C] bf16
    qslot: torch.Tensor,        # [M] candidate row of each slot
    locs: torch.Tensor,         # [M, 3] float32
    center: torch.Tensor,       # [M, 3] float32
    rd: torch.Tensor,           # [M, 3] float32
    mask: torch.Tensor,         # [M] bool
    *, K: int, radius2: float, num_shells: int,
    nff: int, ndf: int, nvf: int, act_super: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sig [M] f32, rgb [M, 3] f32, found [M] bool) for all M slots.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not kmeta.is_cuda:
        return fused_chunk_decode_reference(
            params, Rw2c, camrotc2w, campos, kmeta, kpay, qslot, locs,
            center, rd, mask, K=K, radius2=radius2, num_shells=num_shells,
            nff=nff, ndf=ndf, nvf=nvf, act_super=act_super)
    dev = kmeta.device
    max_q, C = kmeta.shape
    M = qslot.shape[0]
    if (nff, ndf, nvf) != (3, 5, 4):
        raise ValueError("the CUDA fused chunk kernel is built for PE "
                         "freqs (3, 5, 4)")
    if not (1 <= K <= 8 and 1 <= C <= 64):
        raise ValueError(f"the CUDA fused chunk kernel needs K <= 8 and "
                         f"C <= 64, got K={K}, C={C}")
    _cuda.require(kmeta, "kmeta", torch.int32, (max_q, C), dev)
    _cuda.require(kpay, "kpay", torch.bfloat16, (max_q, PK, C), dev)
    _cuda.require(qslot, "qslot", torch.int32, (M,), dev)
    for name, t in (("locs", locs), ("center", center), ("rd", rd)):
        _cuda.require(t, name, torch.float32, (M, 3), dev)
    _cuda.require(mask, "mask", torch.bool, (M,), dev)
    plist, n_rest = _prep_params(params, FEAT, nff, ndf, nvf)
    packed = _kernel_params(plist, n_rest)
    _cuda.require(packed, "aggregator weights", torch.bfloat16,
                  (packed.numel(),), dev)
    consts = torch.cat([campos.reshape(3), camrotc2w.reshape(9),
                        Rw2c.reshape(9)]).float().to(dev).contiguous()
    sig = torch.empty(M, dtype=torch.float32, device=dev)
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    found = torch.empty(M, dtype=torch.bool, device=dev)
    lib = _cuda.library("fused_chunk")
    lib.fused_chunk_n_params.restype = ctypes.c_int
    if lib.fused_chunk_n_params() != packed.numel():
        raise RuntimeError("packed parameter layout does not match "
                           "csrc/fused_chunk.cu")
    fn = lib.fused_chunk_decode
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["fused_chunk_decode"] += 1
    _cuda.check(fn(*[_cuda.ptr(t) for t in (
        kmeta, kpay, qslot, locs, center, rd, mask, consts, packed, sig,
        rgb, found)], M, C, K, float(radius2), int(num_shells),
        int(act_super), _cuda.stream_handle(dev)),
        "fused_chunk_decode launch")
    return sig, rgb, found
