"""Plain PyTorch reference of a Point-NeRF frame and a Point-NeRF train
step, for the benchmark's correctness check.

It imports nothing of the program, of JAX or of the JAX package, and
takes nothing the program made: it works out the grid, the query voxels,
each ray's samples, each sample's K nearest points, the MLP tower, the
composite, the losses, the gradients (torch autograd) and the Adam update
again from the cloud, the weights and the rays the benchmark made.

What it computes, as the configuration file states it:

- Grid: voxels of `vsize * vscale` from the live points' box, clipped to
  `ranges` and padded by `kernel_size / 2` voxels, dims rounded up to
  `grid_dim_pad`; a voxel keeps its first `P` points by index and the
  first `max_o` occupied voxels (flat-id order) count; a query voxel is
  one within the `query_size` window of an occupied one (the first
  `max_q` of them in flat-id order).
- Candidates of a query voxel: the points of the occupied voxels of its
  `kernel_size` neighbourhood, scanned shell by shell (Chebyshev), the
  first `cand_cap` by the f32 key shell * 1e12 + min(d2 to the voxel
  centre, 1e9), stably.
- Samples: `z_depth_dim` stratified samples in [near, far]; a sample is
  valid in a query voxel; a ray takes its first `S` valid samples
  (S = min(SR, ray_slot_budget) on the frame route, SR on the train
  route) and the train route's batch keeps the first R * compact_budget
  of them in ray order.
- Neighbours: the K nearest candidates within radius_limit_scale *
  vsize, shell 1 searched only while shell 0 kept fewer than K, ties to
  the earlier candidate. On the frame route the candidate payload is in
  bfloat16, relative to the query voxel's centre (the configuration's
  `fused` cache layout); on the train route in float32.
- Tower: inverse-distance weights normalised over K, the per-neighbour
  MLP (mlp_base, mlp_head, density), order-2 aggregation, the colour MLP
  on the weighted feature and the view direction's encoding; sin/cos
  positional encodings evaluated directly, in float32 (TF32 off).
- Composite: camera-space z of the valid slots, steps by the running
  max (a step under 1e-8 or over 2 * vsize_z becomes vsize_z), opacity
  1 - exp(-sigma * step), exclusive transmittance, colour + (1 - acc) *
  background; a ray with no slot that found a neighbour is background.
- Train step: the ray-masked colour MSE plus the zero-one confidence
  term, both Adam groups with the exponential decay.

`precision` "float32" is the reference. The control is the nearest
precision below the configuration's tower (`control_precision`): "tf32"
for a float32 tower (TF32 off), every tower matmul's operands rounded to
TF32's 10-bit mantissa, in the backward too, with float32 products and
sums, as a TF32 GEMM computes; "fp8" for a bfloat16 tower, every tower
matmul's operands, product and bias sum rounded to float8 e4m3 under a
per-tensor scale (float32 accumulation), and their gradients likewise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
TOWERS = ("mlp_base", "mlp_head", "density_head", "mlp_color", "color_head")


# --------------------------------------------------------------------- weights


def tower_dims(agg: dict) -> Dict[str, List[Tuple[int, int]]]:
    """(in, out) of each layer of each tower (order 2, linear kernel,
    point colour and direction on, 6 distance channels)."""
    C, H, HC = agg["point_features_dim"], agg["hidden_size"], \
        agg["hidden_size_color"]
    base_in = C + 2 * agg["num_feat_freqs"] * C + 2 * agg["num_dist_freqs"] * 6
    head_in = H + 3 + 4
    color_in = H + 2 * agg["num_viewdir_freqs"] * 3

    def tower(i, w, n):
        return [(i, w)] + [(w, w)] * (n - 1)

    return {"mlp_base": tower(base_in, H, agg["num_mlp_base_layers"]),
            "mlp_head": tower(head_in, H, agg["num_mlp_head_layers"]),
            "density_head": [(H, 1)],
            "mlp_color": tower(color_in, HC, agg["num_color_layers"]),
            "color_head": [(HC, 3)]}


def n_weights(agg: dict) -> int:
    return sum(i * o + o for d in tower_dims(agg).values() for i, o in d)


def split_weights(flat: torch.Tensor, agg: dict
                  ) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """A flat vector of uniform [0, 1) draws -> {tower: [(W [out, in],
    b [out])]} in the order of `tower_dims`: W uniform within
    +-sqrt(6 / (1.01 in)) (He's bound for LeakyReLU(0.1), so that every
    layer keeps its input's scale and the outputs depend on the
    neighbours; nn.Linear's default bound, 1 / sqrt(in), shrinks the
    signal some 6x in variance a layer and leaves each output at its
    bias), b within +-1 / sqrt(in)."""
    out, at = {}, 0
    for name, dims in tower_dims(agg).items():
        layers = []
        for i, o in dims:
            bound = 1.0 / math.sqrt(i)
            w = (flat[at:at + i * o].view(o, i) * 2 - 1) \
                * math.sqrt(6.0 / (1.01 * i))
            at += i * o
            b = (flat[at:at + o] * 2 - 1) * bound
            at += o
            layers.append((w, b))
        out[name] = layers
    return out


# ------------------------------------------------------------------------ grid


@dataclasses.dataclass
class Grid:
    rmin: torch.Tensor          # [3] f32 origin
    svs: torch.Tensor           # [3] f32 voxel edge
    dims: Tuple[int, int, int]
    occ_slot: torch.Tensor      # [nvox] long: occupied slot or -1
    slot_pts: torch.Tensor      # [n_occ, P] long point ids, -1 padded
    qslot: torch.Tensor         # [nvox] long: query-voxel rank or -1


def grid_geometry(xyz_min: np.ndarray, xyz_max: np.ndarray, q: dict):
    """(origin [3] float32, dims) of the dense grid over the live points'
    box (numpy float32 arithmetic)."""
    ranges = np.asarray(q["ranges"], np.float32)
    svs = np.asarray([v * s for v, s in zip(q["vsize"], q["vscale"])],
                     np.float32)
    ks = np.asarray(q["kernel_size"], np.float32)
    lo = np.maximum(np.asarray(xyz_min, np.float32), ranges[:3]) - svs * ks / 2
    hi = np.minimum(np.asarray(xyz_max, np.float32), ranges[3:]) + svs * ks / 2
    vdim = (hi - lo) / np.asarray(q["vsize"], np.float32)
    dims = np.ceil(vdim / np.asarray(q["vscale"], np.float32)).astype(np.int64)
    pad = q["grid_dim_pad"]
    dims = np.maximum((dims + pad - 1) // pad * pad, pad)
    return lo, tuple(int(d) for d in dims)


def build_grid(xyz: torch.Tensor, q: dict, max_q: int) -> Grid:
    dev = xyz.device
    lo, dims = grid_geometry(xyz.min(0).values.cpu().numpy(),
                             xyz.max(0).values.cpu().numpy(), q)
    rmin = torch.as_tensor(lo, device=dev)
    svs = torch.tensor([v * s for v, s in zip(q["vsize"], q["vscale"])],
                       dtype=F32, device=dev)
    gx, gy, gz = dims
    nvox = gx * gy * gz
    g = torch.floor((xyz - rmin) / svs).long()
    inb = ((g >= 0) & (g < torch.tensor(dims, device=dev))).all(-1)
    flat = torch.where(inb, (g[:, 0] * gy + g[:, 1]) * gz + g[:, 2], nvox)
    order = torch.sort(flat, stable=True).indices          # by voxel, index
    fs = flat[order]
    vox, counts = torch.unique_consecutive(fs, return_counts=True)
    live = vox < nvox
    vox, counts = vox[live][:q["max_o"]], counts[live][:q["max_o"]]
    starts = torch.cumsum(counts, 0) - counts
    P = q["P"]
    rank = torch.arange(P, device=dev)
    take = starts[:, None] + rank[None, :]
    slot_pts = torch.where(rank[None, :] < counts[:, None],
                           order[torch.clamp(take, max=order.numel() - 1)], -1)
    occ_slot = torch.full((nvox,), -1, dtype=torch.long, device=dev)
    occ_slot[vox] = torch.arange(vox.numel(), device=dev)
    occ = (occ_slot >= 0).float().view(1, 1, gx, gy, gz)
    window = tuple(q["query_size"])
    pads = []
    for w in reversed(window):
        pads += [(w + 1) // 2 - 1, w // 2]
    query = F.max_pool3d(F.pad(occ, pads), window, stride=1).view(-1) > 0
    qrank = torch.cumsum(query.long(), 0) - 1
    qslot = torch.where(query & (qrank < max_q), qrank, -1)
    return Grid(rmin, svs, dims, occ_slot, slot_pts, qslot)


def voxel_of(grid: Grid, pos: torch.Tensor):
    """(voxel [..., 3] long, inside the grid [...], flat id clamped)."""
    g = torch.floor((pos - grid.rmin) / grid.svs).long()
    dims = torch.tensor(grid.dims, device=pos.device)
    inb = ((g >= 0) & (g < dims)).all(-1)
    gc = torch.minimum(torch.clamp(g, min=0), dims - 1)
    flat = (gc[..., 0] * grid.dims[1] + gc[..., 1]) * grid.dims[2] + gc[..., 2]
    return g, inb, flat


def scan_offsets(kernel_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel offsets [V, 3] in scan order (shell by shell, x-major) and
    their Chebyshev shell."""
    offs, shells = [], []
    for layer in range((kernel_size[0] + 1) // 2):
        for x in range(-layer, layer + 1):
            for y in range(-layer, layer + 1):
                for z in range(-layer, layer + 1):
                    if max(abs(x), abs(y), abs(z)) == layer:
                        offs.append((x, y, z))
                        shells.append(layer)
    return torch.tensor(offs), torch.tensor(shells)


def candidates(grid: Grid, xyz: torch.Tensor, vox: torch.Tensor, q: dict):
    """The candidate lists of query voxels vox [B, 3]: (pidx [B, C] long,
    -1 empty; shell [B, C] long; centre [B, 3] f32), C = cand_cap."""
    dev = xyz.device
    offs, shells = (t.to(dev) for t in scan_offsets(q["kernel_size"]))
    V, P = offs.shape[0], grid.slot_pts.shape[1]
    dims = torch.tensor(grid.dims, device=dev)
    nb = vox[:, None, :] + offs[None]
    inb = ((nb >= 0) & (nb < dims)).all(-1)
    nbc = torch.minimum(torch.clamp(nb, min=0), dims - 1)
    flat = (nbc[..., 0] * grid.dims[1] + nbc[..., 1]) * grid.dims[2] \
        + nbc[..., 2]
    slot = torch.where(inb, grid.occ_slot[flat], -1)
    pidx = torch.where((slot >= 0)[..., None],
                       grid.slot_pts[torch.clamp(slot, min=0)], -1)
    B = vox.shape[0]
    pidx = pidx.reshape(B, V * P)
    sh = shells[:, None].expand(V, P).reshape(-1).expand(B, V * P)
    centre = (grid.rmin.double() + (vox.double() + 0.5)
              * grid.svs.double()).float()
    dd = xyz[torch.clamp(pidx, min=0)] - centre[:, None, :]
    d2 = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] \
        + dd[..., 2] * dd[..., 2]
    key = sh.float() * 1e12 + torch.clamp(d2, max=1e9)
    key = torch.where(pidx >= 0, key, float("inf"))
    top = torch.sort(key, dim=-1, stable=True).indices[:, :q["cand_cap"]]
    return torch.gather(pidx, 1, top), torch.gather(sh, 1, top), centre


def k_nearest(d2: torch.Tensor, ok: torch.Tensor, shell: torch.Tensor,
              K: int, n_shells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(column [M, K], found [M, K]) of the K smallest d2 among `ok`, a
    shell searched only while the shells inside it kept fewer than K, ties
    to the earlier column."""
    eligible = shell == 0
    before = torch.zeros_like(shell[:, :1])
    for s in range(1, n_shells):
        before = before + (ok & (shell == s - 1)).sum(-1, keepdim=True)
        eligible = eligible | ((shell == s) & (before < K))
    key = torch.where(ok & eligible, d2, float("inf"))
    top_key, top = torch.sort(key, dim=-1, stable=True)
    return top[:, :K], top_key[:, :K] < float("inf")


# ----------------------------------------------------------------------- tower


def _pe(x: torch.Tensor, n: int) -> torch.Tensor:
    """sin, cos of x * 2^f per (channel, octave), interleaved."""
    f = 2.0 ** torch.arange(n, device=x.device, dtype=x.dtype)
    s = (x[..., None] * f).reshape(x.shape[:-1] + (-1,))
    return torch.stack([torch.sin(s), torch.cos(s)], -1).reshape(
        x.shape[:-1] + (-1,))


def _pe_ori(x: torch.Tensor, n: int) -> torch.Tensor:
    """[sin of every (channel, octave), cos of every one]."""
    f = 2.0 ** torch.arange(n, device=x.device, dtype=x.dtype)
    s = (x[..., None] * f).reshape(x.shape[:-1] + (-1,))
    return torch.cat([torch.sin(s), torch.cos(s)], -1)


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (the tensor's
    largest magnitude onto e4m3's largest, 448), as a float8 GEMM's
    operands are scaled."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    return (x / s).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(F32) * s


class _Fp8(torch.autograd.Function):
    """Rounds its input to scaled float8 e4m3, and the gradient that comes
    back through it too, as a tower trained in float8 rounds both."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


def control_precision(agg: dict) -> str:
    """The control's precision for the configuration's tower dtype."""
    return {"float32": "tf32", "bfloat16": "fp8"}[agg["compute_dtype"]]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to nearest, ties to even, at TF32's 10-bit
    mantissa (the low 13 bits cleared); infinities and NaNs unchanged."""
    i = x.contiguous().view(torch.int32)
    low = i & 0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((i & 0x2000) != 0))
    r = (i & ~0x1FFF) + up.to(torch.int32) * 0x2000
    finite = (i & 0x7F800000) != 0x7F800000
    return torch.where(finite, r, i).view(torch.float32)


class _Tf32Linear(torch.autograd.Function):
    """x @ W^T as a TF32 GEMM computes it, forward and backward: each
    GEMM's two operands rounded to TF32, products and sums in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _tf32(x), _tf32(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _tf32(g)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x in `precision`: unchanged for "float32"; for "fp8" rounded to
    scaled float8 e4m3 on the way forward and on the way back."""
    return _Fp8.apply(x) if precision == "fp8" else x


def _lin(x, wb, precision):
    """x @ W^T + b; under "tf32" the GEMM's operands are rounded to TF32
    (`_Tf32Linear`); under "fp8" the operands, the product and the sum are
    each rounded to float8 e4m3 (products accumulated in float32), as a
    tower computed in that precision rounds them, and so are their
    gradients."""
    w, b = wb
    if precision == "tf32":
        return _Tf32Linear.apply(x, w) + b
    y = _q(_q(x, precision) @ _q(w, precision).T, precision)
    return _q(y + _q(b, precision), precision)


def _mlp(x, layers, precision):
    for wb in layers:
        x = F.leaky_relu(_lin(x, wb, precision), 0.1)
    return x


def decode(weights, agg: dict, emb, color, ndir, dists, w, mask, viewdir,
           precision: str = "float32"):
    """(sigma [M], rgb [M, 3]) of M slots from their K neighbours: emb
    [M, K, C], color and ndir [M, K, 3], dists [M, K, 6] (world delta,
    perspective delta), normalised weights w [M, K], mask [M, K], the
    ray's unit direction viewdir [M, 3]."""
    wm = (w * mask.to(w.dtype))[..., None]
    feat = torch.cat([emb, _pe(emb, agg["num_feat_freqs"]),
                      _pe(dists, agg["num_dist_freqs"])], -1)
    feat = _mlp(feat, weights["mlp_base"], precision)
    vd = viewdir[:, None, :].expand_as(ndir)
    feat = torch.cat([feat, color, ndir - vd,
                      (ndir * vd).sum(-1, keepdim=True)], -1)
    h = _mlp(feat, weights["mlp_head"], precision)
    alpha = F.relu(_lin(h, weights["density_head"][0], precision))
    sigma = (alpha * wm).sum(-2)[..., 0]
    agg_feat = (h * wm).sum(-2)
    c = torch.cat([agg_feat, _pe_ori(viewdir, agg["num_viewdir_freqs"])], -1)
    c = _mlp(c, weights["mlp_color"], precision)
    rgb = torch.sigmoid(_lin(c, weights["color_head"][0], precision))
    return sigma, rgb * (1 + 2e-3) - 1e-3


def to_camera(p, camrot, campos):
    """R_c2w^T (p - campos), as elementwise multiply-adds."""
    return ((p - campos)[..., :, None] * camrot).sum(-2)


def neighbour_dists(nxyz, loc, camrot, campos):
    """[M, K, 6]: the world delta and the perspective delta (x/z * z,
    y/z * z, z of the neighbour less the sample's)."""
    nc = to_camera(nxyz, camrot, campos)
    lc = to_camera(loc, camrot, campos)[:, None, :]
    pd = torch.stack([nc[..., 0] / nc[..., 2] * nc[..., 2]
                      - lc[..., 0] / lc[..., 2] * lc[..., 2],
                      nc[..., 1] / nc[..., 2] * nc[..., 2]
                      - lc[..., 1] / lc[..., 2] * lc[..., 2],
                      nc[..., 2] - lc[..., 2]], -1)
    return torch.cat([nxyz - loc[:, None, :], pd], -1)


def composite(sigma, rgb, z, valid, vsize_z: float):
    """Per-row composite of [R, S] slots: (rgb_sum [R, 3], acc [R], depth
    [R])."""
    zm = torch.where(valid, z, torch.full_like(z, -1e9))
    zmax = torch.cummax(zm, -1).values
    step = torch.cat([zmax[:, 1:] - zmax[:, :-1],
                      torch.full_like(zmax[:, :1], vsize_z)], -1)
    step = torch.where((step < 1e-8) | (step > 2 * vsize_z),
                       torch.full_like(step, vsize_z), step)
    step = step * valid.to(step.dtype)
    opacity = 1.0 - torch.exp(-sigma * step)
    trans = torch.cumprod(1.0 - opacity + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    blend = opacity * trans
    return (blend[..., None] * rgb).sum(-2), blend.sum(-1), (blend * z).sum(-1)


# ---------------------------------------------------------------------- frames


def frame_samples(grid: Grid, campos, rd, near: float, far: float, q: dict,
                  block: int = 4096):
    """Each ray's first S valid samples on the frame route: (d [R, S]
    long, D where empty; count [R]). Sample d lies at near + (d + 0.5) *
    (far - near) / D along the ray."""
    dev = rd.device
    D = q["z_depth_dim"]
    S = min(q["SR"], q["ray_slot_budget"] or min(q["SR"], 32), D)
    nr = torch.tensor(near, dtype=F32, device=dev)
    step = (torch.tensor(far, dtype=F32, device=dev) - nr) / D
    t = nr + (torch.arange(D, device=dev).to(F32) + 0.5) * step
    ds, cnts = [], []
    col = torch.arange(D, device=dev)
    for s in range(0, rd.shape[0], block):
        pos = campos + rd[s:s + block, None, :] * t[None, :, None]
        _, inb, flat = voxel_of(grid, pos)
        valid = inb & (grid.qslot[flat] >= 0)
        key = torch.where(valid, col, D)
        ds.append(torch.sort(key, -1).values[:, :S])
        cnts.append(valid.sum(-1))
    return torch.cat(ds), torch.cat(cnts), step


def render_rays(weights, cloud: dict, grid: Grid, campos, camrot, rd,
                near: float, far: float, cfg: dict, bg,
                precision: str = "float32", block: int = 4096,
                count_only: bool = False) -> dict:
    """The frame route's outputs for rays rd [R, 3] (unit, float32):
    {"color", "acc", "depth", "ray_mask", "n_slots", "n_rows", "n_found"},
    the last three the valid samples, the (sample, neighbour) rows found
    and the samples that found a neighbour. `count_only`: the counts
    alone, without the tower and the composite."""
    q, agg = cfg["query"], cfg["agg"]
    K = q["K"]
    r2 = float(q["radius_limit_scale"] * max(q["vsize"][0], q["vsize"][1])) ** 2
    n_shells = (q["kernel_size"][0] + 1) // 2
    d_sel, cnt, step = frame_samples(grid, campos, rd, near, far, q)
    D = q["z_depth_dim"]
    nr = torch.tensor(near, dtype=F32, device=rd.device)
    payload = torch.cat([cloud["emb"], cloud["conf"], cloud["dir"],
                         cloud["color"]], -1).to(torch.bfloat16).to(F32)
    outs = {k: [] for k in ("color", "acc", "depth", "ray_mask")}
    n_slots = n_rows = n_found = 0
    for s in range(0, rd.shape[0], block):
        db = d_sel[s:s + block]
        R, S = db.shape
        live = db < D
        ray, col = torch.nonzero(live, as_tuple=True)
        dv = db[ray, col]
        t = nr + (dv.to(F32) + 0.5) * step
        r_d = rd[s:s + block][ray]
        loc = campos + r_d * t[:, None]
        g, _, flat = voxel_of(grid, loc)
        cen = grid.rmin + (torch.floor((loc - grid.rmin) / grid.svs) + 0.5) \
            * grid.svs
        uq, inv = torch.unique(flat, return_inverse=True)
        gq = torch.stack([uq // (grid.dims[1] * grid.dims[2]),
                          (uq // grid.dims[2]) % grid.dims[1],
                          uq % grid.dims[2]], -1)
        cp, csh, ccw = candidates(grid, cloud["xyz"], gq, q)
        pidx, shell = cp[inv], csh[inv]
        rel = (cloud["xyz"][torch.clamp(pidx, min=0)]
               - ccw[inv][:, None, :]).to(torch.bfloat16).to(F32)
        d = rel + (cen - loc)[:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        ok = (pidx >= 0) & (d2 <= r2)
        top, found = k_nearest(d2, ok, shell, K, n_shells)
        n_slots += int(live.sum())
        n_rows += int(found.sum())
        n_found += int(found.any(-1).sum())
        if count_only:
            continue
        nb = torch.gather(pidx, 1, top)
        nxyz = torch.gather(rel, 1, top[..., None].expand(-1, -1, 3)) \
            + cen[:, None, :]
        dw = nxyz - loc[:, None, :]
        w = found.to(F32) / torch.clamp(torch.sqrt(
            dw[..., 0] * dw[..., 0] + dw[..., 1] * dw[..., 1]
            + dw[..., 2] * dw[..., 2]), min=1e-6)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
        pay = payload[torch.clamp(nb, min=0)] * found[..., None].to(F32)
        dists = neighbour_dists(nxyz, loc, camrot, campos)
        sigma, rgb = decode(weights, agg, pay[..., :32], pay[..., 36:39],
                            pay[..., 33:36], dists, w, found, r_d, precision)
        slot_ok = found.any(-1)
        z = to_camera(loc, camrot, campos)[:, 2]

        def grid_of(x, fill=0.0):
            out = torch.full((R, S) + x.shape[1:], fill, dtype=x.dtype,
                             device=x.device)
            out[ray, col] = x
            return out

        ok_g = grid_of(slot_ok, False)
        rgb_sum, acc, depth = composite(grid_of(sigma * slot_ok), grid_of(rgb),
                                        grid_of(z), ok_g, q["vsize"][2])
        color = rgb_sum + (1 - acc)[:, None] * bg
        ray_mask = (cnt[s:s + block] > 0) & ok_g.any(-1)
        outs["color"].append(torch.where(ray_mask[:, None], color, bg))
        outs["acc"].append(acc)
        outs["depth"].append(depth)
        outs["ray_mask"].append(ray_mask)
    res = {k: torch.cat(v) for k, v in outs.items() if v}
    res.update(n_slots=n_slots, n_rows=n_rows, n_found=n_found)
    return res


# ----------------------------------------------------------------------- train


def train_forward(weights, attrs: dict, xyz, grid: Grid, campos, camrot, rd,
                  gt, jitter_u, near: float, far: float, cfg: dict,
                  precision: str = "float32"):
    """The train route's loss of one batch (rays rd [R, 3], colours gt [R,
    3], jitter draws jitter_u [R, D]), differentiable in `weights` and the
    point attributes `attrs` (emb, conf, dir, color): (loss, rows found,
    slots that found a neighbour)."""
    q, agg, tr = cfg["query"], cfg["agg"], cfg["train"]
    dev = rd.device
    R, D, SR, K = rd.shape[0], q["z_depth_dim"], q["SR"], q["K"]
    r2 = float(q["radius_limit_scale"] * max(q["vsize"][0], q["vsize"][1])) ** 2
    n_shells = (q["kernel_size"][0] + 1) // 2
    # jittered stratified samples: segment lengths (1 + j (u - 0.5)) of the
    # unjittered ones, positions at the segments' midpoints
    inv = torch.tensor(1.0 / D, dtype=F32, device=dev)
    u01 = torch.arange(D + 1, device=dev).to(F32) * inv
    u01[-1] = 1.0
    tv = near * (1.0 - u01) + far * u01
    seg = (tv[1:] - tv[:-1]) * (1.0 + tr["jitter"] * (jitter_u - 0.5))
    ends = torch.cat([torch.full((R, 1), near, device=dev),
                      near + torch.cumsum(seg, -1)], -1)
    mid = 0.5 * (ends[:, :-1] + ends[:, 1:])
    pos = campos + rd[:, None, :] * mid[..., None]             # [R, D, 3]
    _, inb, flat = voxel_of(grid, pos)
    valid = inb & (grid.qslot[flat] >= 0)
    ray_hit = valid.any(-1)
    col = torch.arange(D, device=dev)
    first = torch.sort(torch.where(valid, col, D), -1).values[:, :SR]
    ray, c = torch.nonzero(first < D, as_tuple=True)          # ray-major
    M = R * (q["compact_budget"] or SR)
    ray, c = ray[:M], c[:M]
    d = first[ray, c]
    loc = pos[ray, d]
    _, _, lflat = voxel_of(grid, loc)
    uq, uinv = torch.unique(lflat, return_inverse=True)
    gq = torch.stack([uq // (grid.dims[1] * grid.dims[2]),
                      (uq // grid.dims[2]) % grid.dims[1], uq % grid.dims[2]],
                     -1)
    cp, csh, _ = candidates(grid, xyz, gq, q)
    pidx, shell = cp[uinv], csh[uinv]
    dl = xyz[torch.clamp(pidx, min=0)] - loc[:, None, :]
    d2 = dl[..., 0] * dl[..., 0] + dl[..., 1] * dl[..., 1] + dl[..., 2] * dl[..., 2]
    top, found = k_nearest(d2, (pidx >= 0) & (d2 <= r2), shell, K, n_shells)
    nb = torch.clamp(torch.gather(pidx, 1, top), min=0)
    nxyz = xyz[nb]
    dw = nxyz - loc[:, None, :]
    w = found.to(F32) / torch.clamp(torch.sqrt(
        dw[..., 0] * dw[..., 0] + dw[..., 1] * dw[..., 1]
        + dw[..., 2] * dw[..., 2]), min=1e-6)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    dists = neighbour_dists(nxyz, loc, camrot, campos)
    sigma, rgb = decode(weights, agg, attrs["emb"][nb], attrs["color"][nb],
                        attrs["dir"][nb], dists, w, found, rd[ray], precision)
    slot_ok = found.any(-1)
    sig_g = torch.zeros((R, D), device=dev).index_put((ray, d),
                                                      sigma * slot_ok)
    rgb_g = torch.zeros((R, D, 3), device=dev).index_put((ray, d), rgb)
    ok_g = torch.zeros((R, D), dtype=torch.bool, device=dev)
    ok_g[ray, d] = slot_ok
    z = to_camera(pos, camrot, campos)[..., 2]
    rgb_sum, acc, _ = composite(sig_g, rgb_g, z, ok_g, q["vsize"][2])
    bg = torch.tensor(cfg["bg_color"], dtype=F32, device=dev)
    color = rgb_sum + (1 - acc)[:, None] * bg
    ray_mask = ray_hit & ok_g.any(-1)
    color = torch.where(ray_mask[:, None], color, bg)
    rm = ray_mask.to(F32)[:, None]
    loss = ((color - gt) ** 2 * rm).sum() / torch.clamp(rm.sum() * 3.0,
                                                        min=1.0)
    total = loss * 1.0 + 1e-6
    conf = attrs["conf"][nb][..., 0]
    conf = conf - (conf - torch.clamp(conf, 1e-4, 1.0)).detach()
    eps = tr["zero_epsilon"]
    v = torch.clamp(conf, eps, 1.0 - eps)
    pm = found.to(F32)
    zo = ((torch.log(v) + torch.log(1.0 - v)) * pm).sum() / torch.clamp(
        pm.sum(), min=1.0)
    total = total + zo * tr["zero_one_loss_weight"]
    return total, int(found.sum()), int(slot_ok.sum())


class Adam:
    """torch.optim.Adam's update (eps outside the square root) with the
    learning rate lr0 * decay ** (n / span) at the group's update n."""

    def __init__(self, tensors, lr0: float, decay: float, span: int):
        self.p = tensors
        self.m = [torch.zeros_like(t) for t in tensors]
        self.v = [torch.zeros_like(t) for t in tensors]
        self.lr0, self.decay, self.span, self.n = lr0, decay, span, 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.lr0 * self.decay ** (self.n / self.span)
        self.n += 1
        b1c, b2c = 1 - 0.9 ** self.n, 1 - 0.999 ** self.n
        for p, g, m, v in zip(self.p, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(lr / b1c * m / (v.sqrt() / math.sqrt(b2c) + 1e-8))


def train_steps(weights, cloud: dict, grid: Grid, batches, near: float,
                far: float, cfg: dict, precision: str = "float32"):
    """Follow `batches` (campos, camrot, rd, gt, jitter_u) from the given
    weights and cloud: {"loss": [per step], "grad1": {leaf: first
    gradient}, "change": {leaf: parameter change after the steps},
    "rows": [per step]}. Leaves: "<tower>.<layer>.weight|bias" and the
    point attributes "points.<name>"."""
    tr = cfg["train"]
    leaves = {}
    w = {}
    for name, layers in weights.items():
        w[name] = []
        for i, (wt, b) in enumerate(layers):
            wt = wt.detach().clone().requires_grad_(True)
            b = b.detach().clone().requires_grad_(True)
            leaves[f"{name}.{i}.weight"], leaves[f"{name}.{i}.bias"] = wt, b
            w[name].append((wt, b))
    attrs = {k: cloud[k].detach().clone().requires_grad_(True)
             for k in ("emb", "conf", "dir", "color")}
    for k, v in attrs.items():
        leaves[f"points.{k}"] = v
    start = {k: v.detach().clone() for k, v in leaves.items()}
    fields = [v for k, v in leaves.items() if not k.startswith("points.")]
    points = [v for k, v in leaves.items() if k.startswith("points.")]
    span = max(tr["lr_decay_iters"], 1)
    opt_f = Adam(fields, tr["lr_fields"], tr["lr_decay_exp"], span)
    opt_p = Adam(points, tr["lr_points"], tr["lr_decay_exp"], span)
    out = {"loss": [], "rows": [], "found": [], "grad1": None}
    for campos, camrot, rd, gt, u in batches:
        loss, rows, found = train_forward(w, attrs, cloud["xyz"], grid, campos,
                                   camrot, rd, gt, u, near, far, cfg,
                                   precision)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves.values(), grads)]
        if out["grad1"] is None:
            out["grad1"] = {k: g.detach().clone()
                            for k, g in zip(leaves, grads)}
        nf = len(fields)
        opt_f.step(grads[:nf])
        opt_p.step(grads[nf:])
        out["loss"].append(float(loss.detach()))
        out["rows"].append(rows)
        out["found"].append(found)
    out["change"] = {k: (v.detach() - start[k]) for k, v in leaves.items()}
    return out
