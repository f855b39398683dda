"""The radiance decoder's per-neighbour tower as one kernel.

Port of `pointnerf2studio_tpu/ops/fused_decode.py`. Per (shading slot,
neighbour) row the feature [emb, PE_block(emb), PE_block(dists)] (bf16,
block-layout positional encodings, the first-layer weight rows permuted
once by `_w1_permutation`) runs through mlp_base -> mlp_head -> density
head with bf16 operands, float32 accumulation, float32 bias,
LeakyReLU(0.1) and a cast to bf16 per layer; alpha = ReLU(h . wd + bd).
Two variants differ in where they round:

  `fused_decode`   per row aw = alpha * wk (f32) and
                   hw = bf16(f32(bf16 h) * wk); the K-sum runs outside
                   the kernel (hw summed in float32, then rounded to
                   bf16, as the reference's bf16 `jnp.sum` does);
  `fused_decode2`  h stays float32 after layer 4 (rounded to bf16 only
                   for the density dot) and sum_k alpha * wk, sum_k
                   h * wk are taken in float32 in k order.

Both then run the per-slot colour tower (`_color_tower`) in plain torch
and return (sigma [M], rgb [M, 3]).

`pair_tower` and `kacc_tower` are the wrappers of the two entry points
of the hand-written CUDA source `csrc/fused_decode.cu` (replacing the
Pallas kernels `_pair_kernel`, ops/fused_decode.py:91, and
`_kacc_kernel`, :235, of the reference) at the flagship widths (32
features, 6 dists, hidden 256, PE octaves 3 / 5, K <= 8), and of the
entry points `fused_decode_any` / `fused_decode2_any` of
`csrc/decode_any.cu` (both on the warp-specialised wgmma tower of
`csrc/tower_wg.cuh`, whose weights `pack_tower_wg` lays out; counted in
`_cuda.LAUNCHES` under those names) at every other width of
the envelope `check_envelope` states: features 1-64, dist_dim 3, 4 or
6, hidden 1-512, PE octaves 1-10, K 1-32. Outside it both devices raise
NotImplementedError. On CUDA tensors they launch a
kernel; on CPU tensors they run the plain versions
`pair_tower_reference` / `kacc_tower_reference`, which follow the Pallas
kernel bodies step by step. `fused_decode_reference` and
`fused_decode2_reference` are the whole plain functions. The kernels
are bound by their tensor-core products (`wgmma` on the tower of
`csrc/tower.cuh`, whose weights `pack_tower` lays out once per set of
weights in the shared-memory image the kernel reads); rows whose wk is
exactly 0 are skipped there (they add exactly 0), while the plain
versions compute every row. `pe_mode` does not reach these functions: the encodings are
always evaluated directly. The density activation is always ReLU, as in
the reference's kernels (they ignore `act_super`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.models.aggregator import (
    Aggregator, _linear_head, _mlp)
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops.camera import rotate
from pointnerf2studio_torch.ops.encoding import positional_encoding

HIDDEN, FEAT, DIST = 256, 32, 6     # the widths csrc/fused_decode.cu is built for
TUNED_FREQS, TUNED_K = (3, 5), 8
# the envelope of the decode kernels (csrc/decode_any.cu beyond the tuned)
FEAT_MAX, HIDDEN_MAX, FREQS_MAX, K_MAX = 64, 512, 10, 32
DIST_DIMS = (3, 4, 6)


def check_envelope(C: int, D: int, H: int, nff: int, ndf: int,
                   K: int) -> None:
    """Raise NotImplementedError, on any device, for a tower outside the
    widths the decode kernels take: C features 1-64, D dists 3, 4 or 6,
    hidden H 1-512, nff and ndf PE octaves 1-10, K neighbours 1-32."""
    got = {"shading_feature_dim": C, "dist_dim": D, "hidden_size": H,
           "num_feat_freqs": nff, "num_dist_freqs": ndf, "K": K}
    ok = {"shading_feature_dim": 1 <= C <= FEAT_MAX, "dist_dim": D in DIST_DIMS,
          "hidden_size": 1 <= H <= HIDDEN_MAX,
          "num_feat_freqs": 1 <= nff <= FREQS_MAX,
          "num_dist_freqs": 1 <= ndf <= FREQS_MAX, "K": 1 <= K <= K_MAX}
    bad = {k: got[k] for k, v in ok.items() if not v}
    if bad:
        raise NotImplementedError(
            f"the fused decode kernels are not ported for {bad}; they take "
            f"features 1-{FEAT_MAX}, dist_dim {DIST_DIMS}, hidden "
            f"1-{HIDDEN_MAX}, PE octaves 1-{FREQS_MAX} and K 1-{K_MAX}")


def tuned(C: int, D: int, H: int, nff: int, ndf: int, K: int) -> bool:
    """Whether csrc/fused_decode.cu (the tuned wgmma tower) serves these
    widths; every other width of the envelope takes csrc/decode_any.cu."""
    return ((C, D, H, (nff, ndf)) == (FEAT, DIST, HIDDEN, TUNED_FREQS)
            and K <= TUNED_K)


def fused_decode_eligible(cfg: AggregatorConfig, per_point_rw2c: bool,
                          K: int) -> bool:
    """The configurations the decode kernels implement (the reference's
    gate, unchanged); anything else takes `decode_radiance`."""
    return (not per_point_rw2c
            and cfg.agg_intrp_order == 2
            and cfg.agg_distance_kernel in ("linear", "quadric", "avg",
                                            "numlinear", "numquadric")
            and cfg.point_color_mode and cfg.point_dir_mode
            and cfg.num_mlp_base_layers == 2
            and cfg.num_mlp_head_layers == 2
            and cfg.shading_feature_dim == cfg.point_features_dim)


def fused_decode_served(cfg: AggregatorConfig, per_point_rw2c: bool,
                        K: int) -> bool:
    """`fused_decode_eligible`, and for an eligible config a check that
    its widths lie in the envelope of the decode kernels
    (`check_envelope`). Every weight kernel of the gate is served: the
    weights reach the kernels from outside (`tower_inputs`). An eligible
    config outside the envelope raises NotImplementedError on either
    device; it does not take `decode_radiance` quietly."""
    if not fused_decode_eligible(cfg, per_point_rw2c, K):
        return False
    check_envelope(cfg.shading_feature_dim, cfg.dist_dim, cfg.hidden_size,
                   cfg.num_feat_freqs, cfg.num_dist_freqs, K)
    return True


def tower_inputs(cfg: AggregatorConfig, dists, neigh_dir, viewdirs, weight,
                 pnt_mask, Rw2c):
    """What both decode functions take beside emb and colour, from the
    decoder's inputs (dists [M, K, 6], neigh_dir [M, K, 3], viewdirs
    [M, 3] already Rw2c-rotated, weight and pnt_mask [M, K], a global
    Rw2c): (dists_rot [M, K, 6], dirdot [M, K, 4], wk [M, K],
    dir_pe [M, P])."""
    dists_rot = torch.cat([rotate(dists[..., :3], Rw2c), dists[..., 3:]], -1)
    dir_enc = positional_encoding(viewdirs, cfg.num_viewdir_freqs, ori=True)
    ov, dir_pe = dir_enc[..., :3], dir_enc[..., 3:]
    ndir = rotate(neigh_dir.float(), Rw2c)
    dirdot = torch.cat([ndir - ov[:, None, :],
                        (ndir * ov[:, None, :]).sum(-1, keepdim=True)], -1)
    return dists_rot, dirdot, weight * pnt_mask.to(weight.dtype), dir_pe


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


@torch.no_grad()
def _tower_params(agg: Aggregator, C: int, D: int, nff: int, ndf: int):
    """(w1, b1, w2, b2, w3, b3, w4, b4, wd, bd): kernels [in, out] bf16
    (w1's rows permuted to the block PE layout), biases [1, out] f32 -
    the reference's layout."""
    def wb(lin):
        return (lin.weight.T.to(torch.bfloat16),
                lin.bias[None, :].float())

    dev = agg.mlp_base[0].weight.device
    perm = torch.as_tensor(_w1_permutation(C, nff, D, ndf), device=dev)
    w1 = agg.mlp_base[0].weight.T[perm].to(torch.bfloat16)
    b1 = agg.mlp_base[0].bias[None, :].float()
    return ((w1, b1) + wb(agg.mlp_base[1]) + wb(agg.mlp_head[0])
            + wb(agg.mlp_head[1]) + wb(agg.density_head[0]))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.1 * x)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product accumulated in float32."""
    return x.to(torch.bfloat16).float() @ w.float()


def _blocks(M: int):
    return [slice(s, s + _cuda.PLAIN_BLOCK) for s in range(0, M, _cuda.PLAIN_BLOCK)]


@torch.no_grad()
def pair_tower_reference(
    agg: Aggregator, emb, dists, color, dirdot, wk, *, nff: int, ndf: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `pair_tower`, the body of the reference's
    `_pair_kernel` step by step: (aw [M, K] f32, hw [M, K, H] bf16)."""
    bf = torch.bfloat16
    M, K, C = emb.shape
    w1, b1, w2, b2, w3, b3, w4, b4, wd, bd = _tower_params(
        agg, C, dists.shape[-1], nff, ndf)

    def layer(x, w, b):
        return _leaky(_mm(x, w) + b).to(bf)

    aws, hws = [], []
    for s in _blocks(M):
        e, d = emb[s].to(bf), dists[s].to(bf)
        feat = torch.cat([e, _pe_blocks(e, nff), _pe_blocks(d, ndf)], -1)
        x = layer(layer(feat, w1, b1), w2, b2)
        h_in = torch.cat([x, color[s].to(bf), dirdot[s].to(bf)], -1)
        h = layer(layer(h_in, w3, b3), w4, b4)
        alpha = torch.clamp(_mm(h, wd) + bd, min=0.0)
        w = wk[s].float()[..., None]
        aws.append((alpha * w)[..., 0])
        hws.append((h.float() * w).to(bf))
    if not aws:
        return (wk.new_zeros((0, K), dtype=torch.float32),
                wk.new_zeros((0, K, w4.shape[1]), dtype=bf))
    return torch.cat(aws), torch.cat(hws)


@torch.no_grad()
def kacc_tower_reference(
    agg: Aggregator, emb, dists, color, dirdot, wk, *, nff: int, ndf: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `kacc_tower`, the body of the reference's
    `_kacc_kernel` step by step: (aw [M] f32, hw [M, H] f32)."""
    bf = torch.bfloat16
    M, K, C = emb.shape
    D = dists.shape[-1]
    w1, b1, w2, b2, w3, b3, w4, b4, wd, bd = _tower_params(
        agg, C, D, nff, ndf)
    nf = 2 * C * nff
    w1a, w1b, w1c = w1[:C], w1[C:C + nf], w1[C + nf:]
    w3a, w3b = w3[:w2.shape[1]], w3[w2.shape[1]:]

    aws, hws = [], []
    for s in _blocks(M):
        e, d = emb[s].to(bf), dists[s].to(bf)
        x = (_mm(e, w1a) + _mm(_pe_blocks(e, nff), w1b)
             + _mm(_pe_blocks(d, ndf), w1c) + b1)
        x = _leaky(x).to(bf)
        x = _leaky(_mm(x, w2) + b2).to(bf)
        cd = torch.cat([color[s].to(bf), dirdot[s].to(bf)], -1)
        h = _leaky(_mm(x, w3a) + _mm(cd, w3b) + b3).to(bf)
        h = _leaky(_mm(h, w4) + b4)                     # [B, K, H] f32
        alpha = torch.clamp(_mm(h, wd) + bd, min=0.0)
        w = wk[s].float()[..., None]
        aw_c, hw_c = alpha * w, h * w
        aw, hw = aw_c[:, 0], hw_c[:, 0]
        for k in range(1, K):                           # k order
            aw, hw = aw + aw_c[:, k], hw + hw_c[:, k]
        aws.append(aw[:, 0])
        hws.append(hw)
    if not aws:
        return (wk.new_zeros((0,), dtype=torch.float32),
                wk.new_zeros((0, w4.shape[1]), dtype=torch.float32))
    return torch.cat(aws), torch.cat(hws)


SLAB_K = 64             # inputs per weight slab of csrc/tower.cuh


def swizzle_slabs(w: torch.Tensor) -> torch.Tensor:
    """A bf16 [in, out] matrix (in a multiple of 64) as csrc/tower.cuh's
    shared-memory image, flat: one slab per 64 inputs, each slab K-major
    (row n holds the slab's 64 inputs of output n, 128 bytes), and the
    16-byte chunk c of row n stored at chunk c ^ (n & 7) (the 128-byte
    swizzle wgmma reads). Element (k, n) of slab s sits at
    s * 64 * out + n * 64 + ((k // 8) ^ (n & 7)) * 8 + k % 8."""
    rows, n = w.shape
    if rows % SLAB_K or n % 8 or w.dtype != torch.bfloat16:
        raise ValueError(f"cannot slab a {w.dtype} matrix of {tuple(w.shape)}")
    t = w.reshape(rows // SLAB_K, 8, 8, n).permute(0, 3, 1, 2)  # [s,n,c,8]
    pos = torch.arange(8, device=w.device)
    src = pos[None, :] ^ (torch.arange(n, device=w.device) & 7)[:, None]
    idx = src[None, :, :, None].expand(t.shape[0], n, 8, 8)
    return torch.gather(t, 2, idx).reshape(-1).contiguous()


def pack_tower(w1, w2, w3, w4, wd, biases, bd, round_bias: bool):
    """The per-neighbour tower's parameters as csrc/tower.cuh takes them.
    `weights`: 17 bf16 slabs of 64 inputs x 256 outputs - w1 rows 0-255
    (slabs 0-3), the tail slab 4 (inputs 0-31: w1 rows 256-287, inputs
    32-47: w3 rows 256-271, the colour/dirdot rows; zero padded), w2
    (5-8), w3 rows 0-255 (9-12), w4 (13-16). `params`: f32 b1..b4, the
    density head's weights (bf16 values) and its bias, padded to 16;
    with `round_bias` the biases are rounded to bf16 first."""
    H = HIDDEN
    bf = torch.bfloat16
    if (w1.shape[1] != H or w1.shape[0] > 288 or w2.shape != (H, H)
            or w3.shape[1] != H or not H <= w3.shape[0] <= H + 16
            or w4.shape != (H, H) or wd.shape != (H, 1)):
        raise ValueError("the CUDA tower is built for hidden 256, at most "
                         "288 first-layer inputs and 16 colour/dir inputs")
    tail = w1.new_zeros((SLAB_K, H), dtype=bf)
    tail[:w1.shape[0] - H] = w1[H:]
    tail[32:32 + w3.shape[0] - H] = w3[H:]
    weights = torch.cat([swizzle_slabs(m.to(bf).contiguous()) for m in (
        w1[:H], tail, w2, w3[:H], w4)])

    def rb(b):
        b = b.reshape(-1).float()
        return b.to(bf).float() if round_bias else b

    params = torch.cat([rb(b) for b in biases] + [
        wd.reshape(-1).to(bf).float(), rb(bd), bd.new_zeros(15).float()])
    return weights.contiguous(), params.contiguous()


def _tower_tensors(agg: Aggregator):
    return [p for lyr in (*agg.mlp_base, *agg.mlp_head, *agg.density_head)
            for p in (lyr.weight, lyr.bias)]


def _pack_decode(agg: Aggregator, nff: int, ndf: int):
    w1, b1, w2, b2, w3, b3, w4, b4, wd, bd = _tower_params(
        agg, FEAT, DIST, nff, ndf)
    H = HIDDEN
    if (w1.shape != (FEAT + 2 * FEAT * nff + 2 * DIST * ndf, H)
            or w3.shape != (H + 7, H)):
        raise ValueError("the CUDA decode kernels are built for 32 "
                         "features, 6 dists, hidden 256, colour and dir "
                         "modes on")
    return pack_tower(w1, w2, w3, w4, wd, (b1, b2, b3, b4), bd,
                      round_bias=False)


def _kernel_params(agg: Aggregator, nff: int, ndf: int):
    """(weights, params) of `pack_tower` for csrc/fused_decode.cu, packed
    once per set of weights: again only after a weight was moved or
    written in place."""
    return _cuda.packed_once(agg, "_decode_kernel_params",
                             _tower_tensors(agg),
                             lambda: _pack_decode(agg, nff, ndf))


def _launch(entry: str, agg, emb, dists, color, dirdot, wk, nff, ndf):
    dev = emb.device
    M, K, C = emb.shape
    weights, params = _kernel_params(agg, nff, ndf)
    emb = emb.to(torch.bfloat16).contiguous()
    dists = dists.float().contiguous()
    cd = torch.cat([color.float(), dirdot.float()], -1).contiguous()
    wk = wk.float().contiguous()
    _cuda.require(emb, "emb", torch.bfloat16, (M, K, FEAT), dev)
    _cuda.require(dists, "dists", torch.float32, (M, K, DIST), dev)
    _cuda.require(cd, "colour + dirdot", torch.float32, (M, K, 7), dev)
    _cuda.require(wk, "wk", torch.float32, (M, K), dev)
    _cuda.require(weights, "tower weights", torch.bfloat16,
                  (weights.numel(),), dev)
    _cuda.require(params, "tower biases", torch.float32, (params.numel(),),
                  dev)
    lib = _cuda.library("fused_decode")
    lib.fused_decode_n_weight_bytes.restype = ctypes.c_int
    lib.fused_decode_n_params.restype = ctypes.c_int
    if (lib.fused_decode_n_weight_bytes() != 2 * weights.numel()
            or lib.fused_decode_n_params() != params.numel()):
        raise RuntimeError("packed parameter layout does not match "
                           "csrc/fused_decode.cu")
    if entry == "fused_decode":
        aw = torch.empty((M, K), dtype=torch.float32, device=dev)
        hw = torch.empty((M, K, HIDDEN), dtype=torch.bfloat16, device=dev)
    else:
        aw = torch.empty((M,), dtype=torch.float32, device=dev)
        hw = torch.empty((M, HIDDEN), dtype=torch.float32, device=dev)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES[entry] += 1
    _cuda.check(fn(*[_cuda.ptr(t) for t in (
        emb, dists, cd, wk, weights, params, aw, hw)], M, K,
        _cuda.stream_handle(dev)), f"{entry} launch")
    return aw, hw


def padded_width(h: int) -> int:
    """csrc/tower_wg.cuh's padded_width: a layer's width as 64 NT
    outputs, NT 1, 2, 4 or 8."""
    return 64 if h <= 64 else 128 if h <= 128 else 256 if h <= 256 else 512


def round_slab(n: int) -> int:
    """n inputs rounded up to whole slabs of SLAB_K."""
    return -(-n // SLAB_K) * SLAB_K


def _tower_vectors(H: int, wd, biases, bd, round_bias: bool):
    """The f32 parameters of the generic towers: b1..b4 and the density
    head's weights (bf16 values), each zero padded to padded_width(H),
    then its bias and 15 zeros; with `round_bias` the biases are rounded
    to bf16."""
    bf = torch.bfloat16
    n_p = padded_width(H)

    def rb(b):
        b = b.reshape(-1).float()
        b = b.to(bf).float() if round_bias else b
        return torch.cat([b, b.new_zeros(n_p - b.numel())])

    return torch.cat([rb(b) for b in biases] + [
        torch.cat([wd.reshape(-1).to(bf).float(),
                   wd.new_zeros(n_p - H, dtype=torch.float32)]),
        rb(bd)[:1], bd.new_zeros(15, dtype=torch.float32)]).contiguous()


def tower_wg_matrices(w1, w2, w3):
    """The [in, out] shapes of the four layers as csrc/tower_wg.cuh reads
    them, each padded to Np = padded_width(H) outputs and whole slabs of
    64 inputs: w1 [round64(n1), Np], w2 and w4 [Np, Np], w3 [Np + 64, Np]
    (its rows 0 .. H-1, then its colour and dirdot rows at Np .. Np + 6)."""
    H = w2.shape[0]
    n_p = padded_width(H)
    return ((round_slab(w1.shape[0]), n_p), (n_p, n_p), (n_p + SLAB_K, n_p),
            (n_p, n_p))


def slab_image(m: torch.Tensor) -> torch.Tensor:
    """A padded bf16 [kin, Np] matrix (kin a multiple of 64) as
    csrc/tower_wg.cuh streams it, flat: its slabs of 64 inputs one after
    the other, each in `swizzle_slabs`' image; at Np = 512 a slab is two
    images of 256 outputs, the first half's first."""
    kin, n_p = m.shape
    half = min(n_p, 256)
    return torch.stack([
        swizzle_slabs(m[:, h:h + half].contiguous()).reshape(
            kin // SLAB_K, -1) for h in range(0, n_p, half)], 1).reshape(-1)


def pack_tower_wg(w1, w2, w3, w4, wd, biases, bd, round_bias: bool):
    """The per-neighbour tower's parameters as csrc/tower_wg.cuh takes
    them (fused_decode_any, fused_decode2_any, the tower of
    fused_chunk_decode_any). `weights` (bf16): the four [in, out] matrices
    zero padded to the shapes of `tower_wg_matrices` (w1's rows in the
    block PE order), each in `slab_image`'s image, one after the other in
    the order the kernel reads them. `params` (f32): `_tower_vectors`.
    Zero weights with a zero bias add exactly 0, so the padding changes no
    result."""
    bf = torch.bfloat16
    H = w2.shape[0]
    pieces = []
    for w, (kin, n_p), rows in zip(
            (w1, w2, w3, w4), tower_wg_matrices(w1, w2, w3),
            ([(0, 0, w1.shape[0])], [(0, 0, H)],
             [(0, 0, H), (H, padded_width(H), w3.shape[0] - H)],
             [(0, 0, H)])):
        m = w.new_zeros((kin, n_p), dtype=bf)
        for src, dst, n in rows:
            m[dst:dst + n, :H] = w[src:src + n].to(bf)
        pieces.append(slab_image(m))
    return (torch.cat(pieces).contiguous(),
            _tower_vectors(H, wd, biases, bd, round_bias))


def _pack_decode_any(agg: Aggregator, C: int, D: int, nff: int, ndf: int):
    w1, b1, w2, b2, w3, b3, w4, b4, wd, bd = _tower_params(
        agg, C, D, nff, ndf)
    return pack_tower_wg(w1, w2, w3, w4, wd, (b1, b2, b3, b4), bd,
                         round_bias=False)


def _launch_any(entry: str, agg, emb, dists, color, dirdot, wk, nff, ndf):
    """csrc/decode_any.cu's entry `entry` (fused_decode_any or
    fused_decode2_any) on CUDA tensors, its weights by `pack_tower_wg`,
    packed once per set of weights and widths for both entries."""
    dev = emb.device
    M, K, C = emb.shape
    D = dists.shape[-1]
    H = agg.mlp_base[0].weight.shape[0]
    pair = entry == "fused_decode_any"
    weights, params = _cuda.packed_once(
        agg, f"_decode_any_params_{C}_{D}_{nff}_{ndf}", _tower_tensors(agg),
        lambda: _pack_decode_any(agg, C, D, nff, ndf))
    emb = emb.to(torch.bfloat16).contiguous()
    dists = dists.float().contiguous()
    cd = torch.cat([color.float(), dirdot.float()], -1).contiguous()
    wk = wk.float().contiguous()
    _cuda.require(cd, "colour + dirdot", torch.float32, (M, K, 7), dev)
    _cuda.require(wk, "wk", torch.float32, (M, K), dev)
    _cuda.require(weights, "tower weights", torch.bfloat16,
                  (weights.numel(),), dev)
    _cuda.require(params, "tower biases", torch.float32, (params.numel(),),
                  dev)
    lib = _cuda.library("decode_any")
    lib.decode_any_n_weights.restype = ctypes.c_longlong
    lib.decode_any_n_weights.argtypes = [ctypes.c_int] * 5
    lib.decode_any_n_params.restype = ctypes.c_int
    lib.decode_any_n_params.argtypes = [ctypes.c_int]
    if (lib.decode_any_n_weights(C, D, H, nff, ndf) != weights.numel()
            or lib.decode_any_n_params(H) != params.numel()):
        raise RuntimeError("packed parameter layout does not match "
                           "csrc/decode_any.cu")
    if pair:
        aw = torch.empty((M, K), dtype=torch.float32, device=dev)
        hw = torch.empty((M, K, H), dtype=torch.bfloat16, device=dev)
    else:
        aw = torch.empty((M,), dtype=torch.float32, device=dev)
        hw = torch.empty((M, H), dtype=torch.float32, device=dev)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES[entry] += 1
    _cuda.check(fn(*[_cuda.ptr(t) for t in (
        emb, dists, cd, wk, weights, params, aw, hw)], M, K, C, D, H, nff,
        ndf, _cuda.stream_handle(dev)), f"{entry} launch")
    return aw, hw


def _tower(kacc: bool, agg, emb, dists, color, dirdot, wk, nff, ndf):
    """The envelope check on any device, then the plain version (CPU
    tensors), the tuned kernel or the generic one (CUDA tensors)."""
    M, K, C = emb.shape
    D, H = dists.shape[-1], agg.mlp_base[0].weight.shape[0]
    check_envelope(C, D, H, nff, ndf, K)
    if not emb.is_cuda:
        plain = kacc_tower_reference if kacc else pair_tower_reference
        return plain(agg, emb, dists, color, dirdot, wk, nff=nff, ndf=ndf)
    if tuned(C, D, H, nff, ndf, K):
        return _launch("fused_decode2" if kacc else "fused_decode", agg,
                       emb, dists, color, dirdot, wk, nff, ndf)
    return _launch_any("fused_decode2_any" if kacc else "fused_decode_any",
                       agg, emb, dists, color, dirdot, wk, nff, ndf)


@torch.no_grad()
def pair_tower(agg: Aggregator, emb, dists, color, dirdot, wk, *,
               nff: int, ndf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(aw [M, K] f32, hw [M, K, H] bf16) per (slot, k) row. CUDA
    tensors launch a kernel; CPU tensors take the plain version."""
    return _tower(False, agg, emb, dists, color, dirdot, wk, nff, ndf)


@torch.no_grad()
def kacc_tower(agg: Aggregator, emb, dists, color, dirdot, wk, *,
               nff: int, ndf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(aw [M] f32, hw [M, H] f32) summed over k in k order. CUDA
    tensors launch a kernel; CPU tensors take the plain version."""
    return _tower(True, agg, emb, dists, color, dirdot, wk, nff, ndf)


def _color_tower(agg: Aggregator, sigma, agg_feat, dir_pe):
    """Per-slot colour tower on the K-aggregated feature, in bf16 as the
    reference's: (sigma [M], rgb [M, 3] f32)."""
    bf = torch.bfloat16
    color_in = torch.cat([agg_feat.to(bf), dir_pe.to(bf)], -1)
    cfeat = _mlp(agg.mlp_color, color_in, bf)
    rgb = torch.sigmoid(_linear_head(agg.color_head[0], cfeat, bf).float())
    return sigma, rgb * (1 + 2e-3) - 1e-3


def _decode(tower, agg, emb, dists, color, dirdot, wk, dir_pe, nff, ndf):
    aw, hw = tower(agg, emb, dists, color, dirdot, wk, nff=nff, ndf=ndf)
    # hw is bf16 [M, K, H]: summed over K in float32 and rounded to bf16
    # once, the result type of the reference's bf16 jnp.sum
    return _color_tower(agg, aw.sum(-1),
                        hw.float().sum(1).to(torch.bfloat16), dir_pe)


def _decode2(tower, agg, emb, dists, color, dirdot, wk, dir_pe, nff, ndf):
    aw, hw = tower(agg, emb, dists, color, dirdot, wk, nff=nff, ndf=ndf)
    return _color_tower(agg, aw, hw, dir_pe)


@torch.no_grad()
def fused_decode(
    agg: Aggregator,
    emb: torch.Tensor,      # [M, K, C]
    dists: torch.Tensor,    # [M, K, D] already Rw2c-rotated
    color: torch.Tensor,    # [M, K, 3]
    dirdot: torch.Tensor,   # [M, K, 4] = [ndir - ov, <ndir, ov>]
    wk: torch.Tensor,       # [M, K] aggregation weight * mask
    dir_pe: torch.Tensor,   # [M, P] per-slot viewdir PE (sans raw dirs)
    num_feat_freqs: int, num_dist_freqs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused decode -> (sigma [M], rgb [M, 3])."""
    return _decode(pair_tower, agg, emb, dists, color, dirdot, wk, dir_pe,
                   num_feat_freqs, num_dist_freqs)


@torch.no_grad()
def fused_decode_reference(agg, emb, dists, color, dirdot, wk, dir_pe,
                           num_feat_freqs: int, num_dist_freqs: int):
    """Plain version of `fused_decode` on any device."""
    return _decode(pair_tower_reference, agg, emb, dists, color, dirdot, wk,
                   dir_pe, num_feat_freqs, num_dist_freqs)


@torch.no_grad()
def fused_decode2(agg, emb, dists, color, dirdot, wk, dir_pe,
                  num_feat_freqs: int, num_dist_freqs: int):
    """K-accumulating fused decode -> (sigma [M], rgb [M, 3]); same
    arguments as `fused_decode`."""
    return _decode2(kacc_tower, agg, emb, dists, color, dirdot, wk, dir_pe,
                    num_feat_freqs, num_dist_freqs)


@torch.no_grad()
def fused_decode2_reference(agg, emb, dists, color, dirdot, wk, dir_pe,
                            num_feat_freqs: int, num_dist_freqs: int):
    """Plain version of `fused_decode2` on any device."""
    return _decode2(kacc_tower_reference, agg, emb, dists, color, dirdot,
                    wk, dir_pe, num_feat_freqs, num_dist_freqs)
