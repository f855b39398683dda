"""The whole post-gather chunk of the fast render path in one pass.

Port of `pointnerf2studio_tpu/ops/fused_chunk.py`. Per shading slot:
candidate selection (d2 from the bf16 relative xyz, validity / radius /
layered-shell masks, the K smallest d2 with smallest-index tie-break),
payload extract, linear inverse-distance weights normalised over K,
Rw2c-rotated dists plus w2pers offsets, the per-neighbour tower with
weighted alpha/feature sums over K, and the colour tower on the
aggregate plus PE(viewdir). Output: (sigma, rgb, found) per slot.

`fused_chunk_decode` is the wrapper of the hand-written CUDA source
`csrc/fused_chunk.cu` (replacing the Pallas kernel `_kernel`,
ops/fused_chunk.py:86 of the reference; its one entry point launches
three kernels back to back: selection and gathers, the tower, the colour
tower) at the flagship widths (hidden 256, colour 128 x 3 layers, PE
octaves 3 / 5 / 4, K <= 8, C <= 64), and of `csrc/chunk_any.cu`'s
`fused_chunk_decode_any` (the same three steps on the generic towers of
`csrc/tower_any.cuh`, counted in `_cuda.LAUNCHES` under that name) at
every other width of the envelope `check_envelope` states: K 1-32, C
1-256, hidden 1-512, colour width 1-512 and 1-8 colour layers, PE octaves
1-10 each. Outside it both devices raise NotImplementedError. On CUDA
tensors it launches a kernel; on CPU tensors it runs the plain version
`fused_chunk_decode_reference`, which mirrors the Pallas kernel op for
op. Both read the candidate rows through `qslot` from the cache
(`models/fast_render.py::FatCache`). The wrapper takes the cache's
tensors as the kernel reads them: kmeta [max_q, C] int32, the
candidate-major payload kcand [max_q, C, PK] bf16 and the relative-xyz
planes kxyz [max_q, 3, C] bf16. The plain version takes the reference's
logical layout kpay [max_q, PK, C], the view `kcand.transpose(1, 2)`,
and gathers its rows explicitly; the kernel reads kcand and kxyz in
place.

The kernel is bound by its tensor-core products, not by the candidate
bytes; its weights are packed once per set of weights in the
shared-memory image the kernel's wgmma reads (`_kernel_params`); its
source header says how. Slots whose mask is false output (0, 0, False).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops.fused_decode import (
    FREQS_MAX, HIDDEN_MAX, _pe_blocks, _round32, _w1_permutation, pack_tower,
    pack_tower_any, padded_width, swizzle_slabs)

PK = 48                 # payload channels (PAYW = 44 padded to 48)
FEAT = 32               # embedding width the cache payload fixes
K_MAX, C_MAX, COLOUR_LAYERS_MAX = 32, 256, 8   # the envelope's limits


def _widths(agg: Aggregator):
    """(hidden, colour width, colour layers) of an aggregator's towers."""
    return (agg.mlp_base[0].weight.shape[0],
            agg.mlp_color[0].weight.shape[0], len(agg.mlp_color))


def check_envelope(agg: Aggregator, K: int, C: int, nff: int, ndf: int,
                   nvf: int) -> None:
    """Raise NotImplementedError, on any device, for a chunk outside the
    widths the fused chunk kernels take: K neighbours 1-32 of C
    candidates 1-256, hidden 1-512, colour width 1-512 in 1-8 layers, PE
    octaves 1-10 for the embedding, the dists and the view direction."""
    H, HC, layers = _widths(agg)
    got = {"K": K, "cand": C, "hidden_size": H, "hidden_size_color": HC,
           "num_color_layers": layers, "num_feat_freqs": nff,
           "num_dist_freqs": ndf, "num_viewdir_freqs": nvf}
    ok = {"K": 1 <= K <= K_MAX, "cand": 1 <= C <= C_MAX,
          "hidden_size": 1 <= H <= HIDDEN_MAX,
          "hidden_size_color": 1 <= HC <= HIDDEN_MAX,
          "num_color_layers": 1 <= layers <= COLOUR_LAYERS_MAX,
          "num_feat_freqs": 1 <= nff <= FREQS_MAX,
          "num_dist_freqs": 1 <= ndf <= FREQS_MAX,
          "num_viewdir_freqs": 1 <= nvf <= FREQS_MAX}
    bad = {k: got[k] for k, v in ok.items() if not v}
    if bad:
        raise NotImplementedError(
            f"the fused chunk kernels are not ported for {bad}; they take "
            f"K 1-{K_MAX}, C 1-{C_MAX}, hidden and colour width "
            f"1-{HIDDEN_MAX}, 1-{COLOUR_LAYERS_MAX} colour layers and PE "
            f"octaves 1-{FREQS_MAX}")


def tuned(agg: Aggregator, K: int, C: int, nff: int, ndf: int,
          nvf: int) -> bool:
    """Whether csrc/fused_chunk.cu (the tuned kernels) serves these
    widths; every other width of the envelope takes csrc/chunk_any.cu."""
    return (_widths(agg) == (256, 128, 3) and (nff, ndf, nvf) == (3, 5, 4)
            and K <= 8 and C <= 64)


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


def _kernel_params(plist, n_color_rest: int):
    """Pack the prepped weights for csrc/fused_chunk.cu: (weights,
    params). `weights` (bf16) is the tower's 17 slabs (`pack_tower`)
    followed by the colour tower's in the same swizzled K-major image,
    128 outputs wide: wc0 = [wc0a; wc0b] zero padded to 320 inputs (five
    slabs), wc1 and wc2 (two each). `params` (f32) is the tower's (its
    biases rounded to bf16, as the reference's kernel rounds them)
    followed by bc0, bc1, bc2, the colour head's weights as [3, 128] and
    its bias, all bf16 values, padded to 16."""
    (w1a, w1b, w1c, b1, w2, b2, w3a, w3b, b3, w4, b4, wd, bd,
     wc0a, wc0b, bc0) = plist[:16]
    wc1, bc1, wc2, bc2 = plist[16:16 + 2 * n_color_rest]
    wch, bch = plist[-2:]
    bf = torch.bfloat16
    weights, params = pack_tower(
        torch.cat([w1a, w1b, w1c]), w2, torch.cat([w3a, w3b]), w4, wd,
        (b1, b2, b3, b4), bd, round_bias=True)
    wc0 = wc0a.new_zeros((320, 128), dtype=bf)
    wc0[:wc0a.shape[0] + wc0b.shape[0]] = torch.cat([wc0a, wc0b]).to(bf)
    weights = torch.cat([weights] + [swizzle_slabs(m.to(bf).contiguous())
                                     for m in (wc0, wc1, wc2)])

    def rb(x):
        return x.reshape(-1).to(bf).float()

    params = torch.cat([params, rb(bc0), rb(bc1), rb(bc2), rb(wch.T),
                        rb(bch), bch.new_zeros(13).float()])
    return weights.contiguous(), params.contiguous()


def _kernel_params_any(plist, n_color_rest: int):
    """Pack the prepped weights for csrc/chunk_any.cu: (weights, params).
    `weights` (bf16): the tower's (`pack_tower_any`), then the colour
    tower's as [out][in] matrices of Nc = padded_width(HC) outputs: wc0
    [Nc][kin] (its K-sum rows at 0 .. H-1, its PE(viewdir) rows at H ..,
    kin a multiple of 32), then each further layer [Nc][Nc]. `params`
    (f32): the tower's (biases rounded to bf16), then each colour layer's
    bias [Nc], the colour head's weights [3][Nc] and its bias, all bf16
    values, and 13 zeros. Zeros pad every matrix and vector."""
    (w1a, w1b, w1c, b1, w2, b2, w3a, w3b, b3, w4, b4, wd, bd,
     wc0a, wc0b, bc0) = plist[:16]
    rest = plist[16:16 + 2 * n_color_rest]
    wch, bch = plist[-2:]
    bf = torch.bfloat16
    weights, params = pack_tower_any(
        torch.cat([w1a, w1b, w1c]), w2, torch.cat([w3a, w3b]), w4, wd,
        (b1, b2, b3, b4), bd, round_bias=True)
    H, HC = wc0a.shape
    n_c = padded_width(HC)
    wc0 = torch.cat([wc0a, wc0b])
    mats = [wc0.new_zeros((n_c, _round32(wc0.shape[0])), dtype=bf)]
    mats[0][:HC, :wc0.shape[0]] = wc0.T.to(bf)
    for w in rest[0::2]:
        mats.append(w.new_zeros((n_c, n_c), dtype=bf))
        mats[-1][:HC, :HC] = w.T.to(bf)

    def rb(x, n=n_c):
        x = x.reshape(-1).to(bf).float()
        return torch.cat([x, x.new_zeros(n - x.numel())])

    head = torch.zeros((3, n_c), dtype=torch.float32, device=wch.device)
    head[:, :HC] = wch.T.to(bf).float()
    params = torch.cat([params, rb(bc0)] + [rb(b) for b in rest[1::2]] + [
        head.reshape(-1), rb(bch, 16)])
    weights = torch.cat([weights] + [m.reshape(-1) for m in mats])
    return weights.contiguous(), params.contiguous()


def _param_tensors(agg: Aggregator):
    return [p for lyr in (*agg.mlp_base, *agg.mlp_head, *agg.density_head,
                          *agg.mlp_color, *agg.color_head)
            for p in (lyr.weight, lyr.bias)]


def _packed_params(agg: Aggregator, nff: int, ndf: int, nvf: int,
                   any_width: bool = False):
    """`_kernel_params` (or, `any_width`, `_kernel_params_any`) of `agg`,
    packed once per set of weights and octaves: again only after a
    weight was moved or written in place."""
    pack = _kernel_params_any if any_width else _kernel_params
    return _cuda.packed_once(
        agg, f"_chunk_kernel_params_{int(any_width)}_{nff}_{ndf}_{nvf}",
        _param_tensors(agg),
        lambda: pack(*_prep_params(agg, FEAT, nff, ndf, nvf)))


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
    blocks of `_cuda.PLAIN_BLOCK` slots."""
    block = _cuda.PLAIN_BLOCK
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


def fused_chunk_decode_plain(params, Rw2c, camrotc2w, campos, kmeta, kcand,
                             kxyz, *rest, **kw):
    """The plain version behind the wrapper's signature: it reads the
    [max_q, PK, C] view of kcand and has no use for kxyz."""
    return fused_chunk_decode_reference(
        params, Rw2c, camrotc2w, campos, kmeta, kcand.transpose(1, 2), *rest,
        **kw)


@torch.no_grad()
def fused_chunk_decode(
    params: Aggregator,
    Rw2c: torch.Tensor,         # [3, 3]
    camrotc2w: torch.Tensor,    # [3, 3]
    campos: torch.Tensor,       # [3]
    kmeta: torch.Tensor,        # [max_q, C] int32
    kcand: torch.Tensor,        # [max_q, C, PK] bf16, candidate-major
    kxyz: torch.Tensor,         # [max_q, 3, C] bf16, == kcand[:, :, :3].mT
    qslot: torch.Tensor,        # [M] candidate row of each slot
    locs: torch.Tensor,         # [M, 3] float32
    center: torch.Tensor,       # [M, 3] float32
    rd: torch.Tensor,           # [M, 3] float32
    mask: torch.Tensor,         # [M] bool
    *, K: int, radius2: float, num_shells: int,
    nff: int, ndf: int, nvf: int, act_super: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sig [M] f32, rgb [M, 3] f32, found [M] bool) for all M slots.
    CUDA tensors launch the kernel; CPU tensors take the plain version on
    the [max_q, PK, C] view of kcand."""
    dev = kmeta.device
    max_q, C = kmeta.shape
    M = qslot.shape[0]
    _cuda.require(kmeta, "kmeta", torch.int32, (max_q, C), dev)
    _cuda.require(kcand, "kcand", torch.bfloat16, (max_q, C, PK), dev)
    _cuda.require(kxyz, "kxyz", torch.bfloat16, (max_q, 3, C), dev)
    check_envelope(params, K, C, nff, ndf, nvf)
    if not kmeta.is_cuda:
        return fused_chunk_decode_plain(
            params, Rw2c, camrotc2w, campos, kmeta, kcand, kxyz, qslot, locs,
            center, rd, mask, K=K, radius2=radius2, num_shells=num_shells,
            nff=nff, ndf=ndf, nvf=nvf, act_super=act_super)
    _cuda.require(qslot, "qslot", torch.int32, (M,), dev)
    for name, t in (("locs", locs), ("center", center), ("rd", rd)):
        _cuda.require(t, name, torch.float32, (M, 3), dev)
    _cuda.require(mask, "mask", torch.bool, (M,), dev)
    fast = tuned(params, K, C, nff, ndf, nvf)
    weights, fparams = _packed_params(params, nff, ndf, nvf, not fast)
    _cuda.require(weights, "aggregator weights", torch.bfloat16,
                  (weights.numel(),), dev)
    _cuda.require(fparams, "aggregator biases", torch.float32,
                  (fparams.numel(),), dev)
    consts = torch.cat([campos.reshape(3), camrotc2w.reshape(9),
                        Rw2c.reshape(9)]).float().to(dev).contiguous()
    sig = torch.empty(M, dtype=torch.float32, device=dev)
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    found = torch.empty(M, dtype=torch.bool, device=dev)
    ptrs = [_cuda.ptr(t) for t in (
        kmeta, kcand, kxyz, qslot, locs, center, rd, mask, consts, weights,
        fparams)]
    outs = [_cuda.ptr(t) for t in (sig, rgb, found)]
    if fast:
        lib = _cuda.library("fused_chunk")
        lib.fused_chunk_n_weight_bytes.restype = ctypes.c_int
        lib.fused_chunk_n_params.restype = ctypes.c_int
        lib.fused_chunk_scratch_bytes.restype = ctypes.c_longlong
        lib.fused_chunk_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        if (lib.fused_chunk_n_weight_bytes() != 2 * weights.numel()
                or lib.fused_chunk_n_params() != fparams.numel()):
            raise RuntimeError("packed parameter layout does not match "
                               "csrc/fused_chunk.cu")
        # what the kernels hand each other: 120 bytes a (slot, k) pair and
        # 525 a slot, written and read for the valid ones only
        scratch = torch.empty(lib.fused_chunk_scratch_bytes(M, K),
                              dtype=torch.uint8, device=dev)
        entry, widths = "fused_chunk_decode", []
    else:
        H, HC, layers = _widths(params)
        lib = _cuda.library("chunk_any")
        lib.chunk_any_n_weights.restype = ctypes.c_longlong
        lib.chunk_any_n_weights.argtypes = [ctypes.c_int] * 6
        lib.chunk_any_n_params.restype = ctypes.c_int
        lib.chunk_any_n_params.argtypes = [ctypes.c_int] * 3
        lib.chunk_any_scratch_bytes.restype = ctypes.c_longlong
        lib.chunk_any_scratch_bytes.argtypes = [ctypes.c_int] * 3
        if (lib.chunk_any_n_weights(H, HC, layers, nff, ndf, nvf)
                != weights.numel()
                or lib.chunk_any_n_params(H, HC, layers) != fparams.numel()):
            raise RuntimeError("packed parameter layout does not match "
                               "csrc/chunk_any.cu")
        # 120 bytes a (slot, k) pair and 2 * round8(H) + 13 a slot
        scratch = torch.empty(lib.chunk_any_scratch_bytes(M, K, H),
                              dtype=torch.uint8, device=dev)
        entry, widths = "fused_chunk_decode_any", [H, HC, layers, nff, ndf,
                                                   nvf]
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_int] * len(widths) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES[entry] += 1
    _cuda.check(fn(*ptrs, _cuda.ptr(scratch), *outs, M, C, K,
                   float(radius2), int(num_shells), int(act_super), *widths,
                   _cuda.stream_handle(dev)), f"{entry} launch")
    return sig, rgb, found
