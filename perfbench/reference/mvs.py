"""Plain PyTorch reference of the joint MVS + Point-NeRF train step
(upstream Point-NeRF's `mode 0`), for the benchmark's correctness check
of the joint cell.

It imports nothing of the program, of JAX or of the JAX package, and
takes nothing the program made but the ring's flags (departure 4): from
the views, the weights and the draws the benchmark made it computes each
step again, as upstream
(github.com/Xharlie/pointnerf) describes it, in float32 with TF32 off:

- FeatureNet(intermediate=True) (`models/mvs/models.py:716-764`) over
  every view: conv0 3->8->8 (3x3), conv1 8->16 (5x5, stride 2) ->16->16,
  conv2 16->32 (5x5, stride 2) ->32->32, each a convolution without bias
  and a BatchNorm (upstream's ConvBnReLU applies no ReLU), and a 1x1
  `toplayer` with bias on conv2; the levels are the image, conv0 (full
  resolution), conv1 (1/2) and the toplayer (1/4).
- The plane-sweep cost volume at 1/4 resolution
  (`build_volume_costvar_img`, `models.py:885-946`; `homo_warp`,
  `mvs_utils.py:423-473`): `num_depth` planes linear in depth over
  [near, far]; each source view's features and 1/4-resolution colours
  (4x4 means) warped onto each plane by src_proj @ inv(ref_proj) with
  `F.grid_sample(align_corners=True, padding_mode="zeros")`, the depth
  clamped below at 1e-8; channels [reference colours, each source's
  warped colours, the variance of the features over the reference and
  the sources whose sample lands inside (-1, 1)^2].
- CostRegNet (`models.py:766-810`), a 3-D U-Net of 3x3x3 convolutions
  without ReLU: 41->8, 8->16 (stride 2)->16, 16->32 (stride 2)->32,
  32->64 (stride 2)->64, transposed stride-2 stages 64->32, 32->16,
  16->8 each added to its skip; ProbNet, an 8->1 convolution with its
  BatchNorm; a softmax over the planes.
- The depth (`mvs_points_model.py:141-196`): the expectation and the
  standard deviation over the planes' NDC centres (d + 0.5) / D, the
  `prob_filter` gate, and `gau_single_sampler`'s draw e + std * noise
  clamped to [0, 1].
- `gen_points(manual_depth_view=-1)` and `query_embedding`
  (`mvs_points_model.py:224-340`): the 1/4-resolution pixel grid at
  normalised coordinates times (W - 1) and (H - 1), unprojected through
  the reference view's K^-1 and camera-to-world; reprojected through K
  to test that the point lies in the image; the four feature levels
  sampled there by `F.grid_sample`, zero off the image; the direction
  from the camera; the confidence 1; `premlp` over [features of levels
  1-3, colour, direction, confidence].
- The render and the losses of `pointnerf.train_forward` on the
  generated cloud, with its positions differentiable, over the voxel
  grid of the valid points' detached positions at the geometry of the
  configuration's `ranges`, K-nearest over every candidate of the kernel
  (the grid route: no candidate cache, so `cand_cap` does not cut);
  torch autograd; Adam on the MVS stack at a constant `mvs_lr` and on
  the tower at `lr_fields` with the exponential decay (the point
  attributes are generated, not trained).

Departures from upstream, each one the program's and the JAX package's
(ROADMAP section 3), mirrored so that the two compute the same step:

1. Adam trains BatchNorm's stored mean and variance as parameters
   beside its scale and bias; upstream's optimizer holds only the
   modules' parameters.
2. The standard deviation's gradient is 0 where the variance is 0 (a
   probability gone to one plane in float32); upstream's is NaN there.
3. The literal `prob_filter` bin: upstream gathers the bin at
   ceil(expected depth) + 1, but the expectation is an NDC depth in
   [0, 1], not a bin index, so the gate reads bin 2 (bin 1 at depth 0).
4. The outermost ring of generated points lies on the image edge: those
   points sit at pixel 0 or W - 1 and come back through K^-1 and K, so
   their in-bounds test (`x <= W - 1`; true of every point in exact
   arithmetic) is decided by rounding, which differs between two float32
   computations of the same depth. Either outcome is the literal test's,
   and one point of the ring let through or not moves a step's loss by
   whole percents at the CPU tests' size. So `joint_steps` takes the
   ring's flags from the side it is compared with, where given, and
   reports its own beside them (`valid_own`): both then render one
   cloud, and the check counts the ring's flips apart from the mask off
   the ring, which is compared whole (`perfbench/kinds/joint.py`).

The precision "tf32" is the control: every convolution and every
matmul of the premlp and of the tower with its two operands rounded to
TF32's 10-bit mantissa, in the backward too (the gradient that enters
each one rounded, with the operands it saved), and float32 products and
sums, as cuDNN and cuBLAS compute with TF32 on. The geometry stays
float32.

At the cell's size (three 800x800 views, 128 planes) one step fits the
card whole, so nothing here runs in blocks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import pointnerf
from perfbench.reference.pointnerf import _tf32

F32 = torch.float32
BN_EPS = 1e-5
# FeatureNet: (stage, [(in, out, kernel, stride, padding)])
FPN = (("conv0", ((3, 8, 3, 1, 1), (8, 8, 3, 1, 1))),
       ("conv1", ((8, 16, 5, 2, 2), (16, 16, 3, 1, 1), (16, 16, 3, 1, 1))),
       ("conv2", ((16, 32, 5, 2, 2), (32, 32, 3, 1, 1), (32, 32, 3, 1, 1))))
# CostRegNet's convolutions (name, in, out, stride) and transposed stages
UNET_DOWN = (("conv0", None, 8, 1), ("conv1", 8, 16, 2), ("conv2", 16, 16, 1),
             ("conv3", 16, 32, 2), ("conv4", 32, 32, 1), ("conv5", 32, 64, 2),
             ("conv6", 64, 64, 1))
UNET_UP = (("conv7", 64, 32), ("conv9", 32, 16), ("conv11", 16, 8))


def _bn_shapes(name: str, c: int) -> Dict[str, tuple]:
    return {f"{name}.{k}": (c,) for k in ("weight", "bias", "running_mean",
                                          "running_var")}


def weight_shapes(num_views: int, premlp_layers: int) -> Dict[str, tuple]:
    """The MVS stack's tensors by upstream's state-dict names
    (`best_net_mvs.pth`'s `FeatureNet.*` and `premlp.*`; the cost nets
    under `costvol.costreg.*` and `costvol.probnet.*`), with shapes."""
    out = {}
    for stage, layers in FPN:
        for i, (ci, co, k, _, _) in enumerate(layers):
            name = f"FeatureNet.{stage}.{i}"
            out[f"{name}.conv.weight"] = (co, ci, k, k)
            out.update(_bn_shapes(f"{name}.bn", co))
    out["FeatureNet.toplayer.weight"] = (32, 32, 1, 1)
    out["FeatureNet.toplayer.bias"] = (32,)
    d = 63
    for i in range(premlp_layers):
        out[f"premlp.{2 * i}.weight"] = (32, d)
        out[f"premlp.{2 * i}.bias"] = (32,)
        d = 32
    cin = 3 * num_views + 32
    for name, ci, co, _ in UNET_DOWN:
        out[f"costvol.costreg.{name}.conv.weight"] = (co, ci or cin, 3, 3, 3)
        out.update(_bn_shapes(f"costvol.costreg.{name}.bn", co))
    for name, ci, co in UNET_UP:
        out[f"costvol.costreg.{name}.0.weight"] = (ci, co, 3, 3, 3)
        out.update(_bn_shapes(f"costvol.costreg.{name}.1", co))
    out["costvol.probnet.conv.weight"] = (1, 8, 3, 3, 3)
    out.update(_bn_shapes("costvol.probnet.bn", 1))
    return out


# ------------------------------------------------------------- precision


class _RoundIn(torch.autograd.Function):
    """An operand of a TF32 product: rounded on the way forward, the
    gradient passed back as it is."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """A TF32 product's output: unchanged on the way forward, the gradient
    that enters the product's backward rounded."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _op(fn, x, w, precision: str, **kw):
    """fn(x, w, **kw), a convolution or product; under "tf32" its operands
    and the gradient entering its backward are rounded to TF32."""
    if precision == "tf32":
        return _RoundGrad.apply(fn(_RoundIn.apply(x), _RoundIn.apply(w),
                                   **kw))
    return fn(x, w, **kw)


def _bn(x, p, name):
    """BatchNorm with stored statistics, over channel axis 1."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - p[f"{name}.running_mean"].view(shape))
            * torch.rsqrt(p[f"{name}.running_var"] + BN_EPS).view(shape)
            * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape))


# ------------------------------------------------------------------- MVS


def features(p, images, precision: str = "float32") -> List[torch.Tensor]:
    """images [V, H, W, 3] -> the four levels [V, C, h, w]: the images,
    conv0 (8), conv1 (16) and the toplayer (32)."""
    x = images.permute(0, 3, 1, 2)
    levels = [x]
    for stage, layers in FPN:
        for i, (_, _, _, s, pad) in enumerate(layers):
            name = f"FeatureNet.{stage}.{i}"
            x = _bn(_op(F.conv2d, x, p[f"{name}.conv.weight"], precision,
                        stride=s, padding=pad), p, f"{name}.bn")
        levels.append(x)
    levels[3] = (_op(F.conv2d, x, p["FeatureNet.toplayer.weight"], precision)
                 + p["FeatureNet.toplayer.bias"].view(1, -1, 1, 1))
    return levels


def cost_volume(imgs_q, feats, proj, depths) -> torch.Tensor:
    """[1, 3V + C, D, h, w] from the 1/4-resolution colours imgs_q
    [V, 3, h, w], features feats [V, C, h, w] (view 0 the reference) and
    proj [V, 4, 4] (src_proj @ inv(ref_proj) at 1/4 resolution)."""
    V, C, h, w = feats.shape
    D = depths.shape[0]
    dev = feats.device
    ref = feats[:1, :, None].expand(1, C, D, h, w)
    vsum, vsq = ref, ref ** 2
    count = torch.ones((1, 1, D, h, w), device=dev)
    colours = [imgs_q[:1, :, None].expand(1, 3, D, h, w)]
    y, x = torch.meshgrid(torch.arange(h, dtype=F32, device=dev),
                          torch.arange(w, dtype=F32, device=dev),
                          indexing="ij")
    ref_pix = torch.stack([x.reshape(-1), y.reshape(-1),
                           torch.ones(h * w, device=dev)])          # [3, hw]
    for v in range(1, V):
        src = ((proj[v, :3, :3] @ ref_pix)[:, None, :]
               + proj[v, :3, 3, None, None] / depths[None, :, None])
        xy = src[:2] / torch.clamp_min(src[2:], 1e-8)
        gx = xy[0] / ((w - 1) / 2) - 1
        gy = xy[1] / ((h - 1) / 2) - 1
        warped = F.grid_sample(
            torch.cat([feats[v:v + 1], imgs_q[v:v + 1]], 1),
            torch.stack([gx, gy], -1)[None], mode="bilinear",
            padding_mode="zeros", align_corners=True).view(1, C + 3, D, h, w)
        vsum = vsum + warped[:, :C]
        vsq = vsq + warped[:, :C] ** 2
        colours.append(warped[:, C:])
        inside = (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
        count = count + inside.to(F32).view(1, 1, D, h, w)
    inv = 1.0 / count
    return torch.cat(colours + [vsq * inv - (vsum * inv) ** 2], 1)


def depth_probability(p, vol, precision: str = "float32") -> torch.Tensor:
    """CostRegNet and ProbNet over vol [1, Cin, D, h, w] (each of D, h, w
    a multiple of 8), softmax over the planes -> [D, h, w]."""
    if any(n % 8 for n in vol.shape[2:]):
        raise ValueError(f"cost volume {tuple(vol.shape[2:])}: the U-Net's "
                         f"three stride-2 stages need multiples of 8")

    def down(x, name, stride):
        pre = f"costvol.costreg.{name}"
        return _bn(_op(F.conv3d, x, p[f"{pre}.conv.weight"], precision,
                       stride=stride, padding=1), p, f"{pre}.bn")

    def up(x, name):
        pre = f"costvol.costreg.{name}"
        return _bn(_op(F.conv_transpose3d, x, p[f"{pre}.0.weight"], precision,
                       stride=2, padding=1, output_padding=1), p, f"{pre}.1")

    c0 = down(vol, "conv0", 1)
    c2 = down(down(c0, "conv1", 2), "conv2", 1)
    c4 = down(down(c2, "conv3", 2), "conv4", 1)
    x = down(down(c4, "conv5", 2), "conv6", 1)
    x = c4 + up(x, "conv7")
    x = c2 + up(x, "conv9")
    x = c0 + up(x, "conv11")
    logits = _bn(_op(F.conv3d, x, p["costvol.probnet.conv.weight"],
                     precision, padding=1), p, "costvol.probnet.bn")
    return torch.softmax(logits[0, 0], 0)


def depth_stats(prob, gate: float):
    """(NDC expectation, standard deviation, prob_filter gate) [h, w] of
    prob [D, h, w] (departures 2 and 3)."""
    D = prob.shape[0]
    ndc = (torch.arange(D, device=prob.device).to(F32) + 0.5) / D
    ndc = ndc[:, None, None]
    e = (prob * ndc).sum(0)
    var = (prob * (ndc - e) ** 2).sum(0)
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var,
                                                  torch.ones_like(var))),
                      torch.zeros_like(var))
    b = torch.clamp(torch.ceil(e) + 1, 0, D - 1).long()
    return e, std, torch.gather(prob, 0, b[None])[0] > gate


def generate(p, images, K, w2c, c2w, near: float, far: float, noise,
             num_depth: int, gate: float, premlp_layers: int,
             precision: str = "float32", ring_inb=None
             ) -> Dict[str, torch.Tensor]:
    """The reference view's generated cloud of one step (images [V, H, W,
    3], K [V, 3, 3], w2c and c2w [V, 4, 4], view 0 the reference; noise
    [H/4, W/4] the depth draw): {xyz, emb, color, dir, conf [N, ...],
    valid [N], ring [N] (the outermost ring of the pixel grid), valid_own
    [N] (`valid` with the ring's own in-bounds flags)}, N = H/4 * W/4.
    `ring_inb` [N] (where given) is taken for the ring's in-bounds flags
    (departure 4)."""
    V, H, W, _ = images.shape
    h, w = H // 4, W // 4
    dev = images.device
    levels = features(p, images, precision)
    imgs_q = F.avg_pool2d(images.permute(0, 3, 1, 2), 4)
    Kq = K.clone()
    Kq[:, :2] = Kq[:, :2] * 0.25
    P = torch.eye(4, device=dev).repeat(V, 1, 1)
    P[:, :3, :4] = Kq @ w2c[:, :3, :4]
    proj = P @ torch.linalg.inv(P[0])
    t = torch.linspace(0.0, 1.0, num_depth, device=dev)
    prob = depth_probability(
        p, cost_volume(imgs_q, levels[3], proj, near * (1 - t) + far * t),
        precision)
    e, std, gate_ok = depth_stats(prob, gate)
    z = torch.clamp(e + std * noise, 0.0, 1.0) * (far - near) + near
    y, x = torch.meshgrid(
        torch.arange(h, dtype=F32, device=dev) / (h - 1) * (H - 1),
        torch.arange(w, dtype=F32, device=dev) / (w - 1) * (W - 1),
        indexing="ij")
    cam = torch.stack([x * z, y * z, z], -1).reshape(-1, 3) \
        @ torch.linalg.inv(K[0]).T
    rot, pos = c2w[0, :3, :3], c2w[0, :3, 3]
    xy = ((cam / cam[:, 2:3]) @ K[0].T)[:, :2]
    inb_own = ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) & (xy[:, 1] >= 0)
               & (xy[:, 1] <= H - 1))
    ring = torch.zeros((h, w), dtype=torch.bool, device=dev)
    ring[0], ring[-1], ring[:, 0], ring[:, -1] = True, True, True, True
    ring = ring.reshape(-1)
    inb = inb_own if ring_inb is None else torch.where(ring, ring_inb,
                                                       inb_own)
    g = torch.stack([xy[:, 0] / ((W - 1) / 2) - 1,
                     xy[:, 1] / ((H - 1) / 2) - 1], -1).view(1, 1, -1, 2)
    sampled = [F.grid_sample(f[:1], g, mode="bilinear", padding_mode="zeros",
                             align_corners=True)[0, :, 0].T
               * inb[:, None].to(F32) for f in levels]
    dirs = (cam / (torch.linalg.norm(cam, dim=-1, keepdim=True) + 1e-6)) \
        @ rot.T
    conf = torch.ones_like(sampled[0][:, :1])
    emb = torch.cat(sampled[1:] + [sampled[0], dirs, conf], -1)
    for i in range(premlp_layers):
        if i:
            emb = F.relu(emb)
        emb = (_op(torch.matmul, emb, p[f"premlp.{2 * i}.weight"].T, precision)
               + p[f"premlp.{2 * i}.bias"])
    live = gate_ok.reshape(-1) & (z.reshape(-1) > 0)
    return {"xyz": cam @ rot.T + pos, "emb": emb, "color": sampled[0],
            "dir": dirs, "conf": conf, "valid": live & inb, "ring": ring,
            "valid_own": live & inb_own}


# ------------------------------------------------------------------ render


def grid_on(xyz, valid, q: dict) -> pointnerf.Grid:
    """The voxel grid of the valid points at the fixed geometry of the
    configuration's `ranges` box (as the joint step builds it every
    step): a voxel keeps its first P points by index, the first max_o
    occupied voxels (flat-id order) count, and every voxel within the
    query window of an occupied one is a query voxel."""
    dev = xyz.device
    r = np.asarray(q["ranges"], np.float32)
    lo, dims = pointnerf.grid_geometry(r[:3], r[3:], q)
    rmin = torch.as_tensor(lo, device=dev)
    svs = torch.tensor([v * s for v, s in zip(q["vsize"], q["vscale"])],
                       dtype=F32, device=dev)
    gx, gy, gz = dims
    nvox = gx * gy * gz
    g = torch.floor((xyz - rmin) / svs).long()
    inb = valid & ((g >= 0) & (g < torch.tensor(dims, device=dev))).all(-1)
    flat = torch.where(inb, (g[:, 0] * gy + g[:, 1]) * gz + g[:, 2], nvox)
    order = torch.sort(flat, stable=True).indices
    vox, counts = torch.unique_consecutive(flat[order], return_counts=True)
    live = vox < nvox
    vox, counts = vox[live][:q["max_o"]], counts[live][:q["max_o"]]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(q["P"], device=dev)
    take = torch.clamp(starts[:, None] + rank[None, :], max=order.numel() - 1)
    slot_pts = torch.where(rank[None, :] < counts[:, None], order[take], -1)
    occ_slot = torch.full((nvox,), -1, dtype=torch.long, device=dev)
    occ_slot[vox] = torch.arange(vox.numel(), device=dev)
    occ = (occ_slot >= 0).to(F32).view(1, 1, gx, gy, gz)
    pads = []
    for n in reversed(q["query_size"]):
        pads += [(n + 1) // 2 - 1, n // 2]
    query = F.max_pool3d(F.pad(occ, pads), tuple(q["query_size"]),
                         stride=1).view(-1) > 0
    qslot = torch.where(query, torch.cumsum(query.long(), 0) - 1, -1)
    return pointnerf.Grid(rmin, svs, dims, occ_slot, slot_pts, qslot)


# -------------------------------------------------------------------- step


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for cuBLAS and cuDNN inside the block (restored after)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def joint_steps(mvs: Dict[str, torch.Tensor], tower: dict, batches,
                cfg: dict, precision: str = "float32",
                ring_valid=None) -> dict:
    """Follow `batches` (each {images, K, w2c, c2w, campos, camrot, rd,
    gt, noise, jitter_u}) from the MVS weights `mvs` (by `weight_shapes`'
    names) and the tower `tower` ({tower: [(W, b)]}): {"loss": [per
    step], "grad1": {leaf: first gradient}, "change": {leaf: change after
    the steps}, "xyz", "ring" (the first step's cloud), "valid",
    "valid_own", "rows", "found" (per step)}. Leaves "mvs.<name>" and
    "fields.<tower>.<layer>.weight|bias". `ring_valid` (per step, where
    given): the flags of the compared side's cloud, taken for the ring's
    in-bounds flags (`generate`'s `ring_inb`)."""
    with _tf32_off():
        return _joint_steps(mvs, tower, batches, cfg, precision, ring_valid)


def _joint_steps(mvs, tower, batches, cfg, precision, ring_valid):
    m, tr, cam = cfg["mvs"], cfg["train"], cfg["camera"]
    want = weight_shapes(m["num_views"], m["premlp_layers"])
    got = {k: tuple(v.shape) for k, v in mvs.items()}
    if got != want:
        raise KeyError(f"MVS weights differ from upstream's layout: "
                       f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")
    q = cfg["query"]
    q = {**q, "cand_cap": math.prod(q["kernel_size"]) * q["P"]}
    rcfg = {**cfg, "query": q}
    leaves = {f"mvs.{k}": v.detach().clone().requires_grad_(True)
              for k, v in mvs.items()}
    p = {k[4:]: v for k, v in leaves.items()}
    w = {}
    for name, layers in tower.items():
        w[name] = []
        for i, (wt, b) in enumerate(layers):
            wt = wt.detach().clone().requires_grad_(True)
            b = b.detach().clone().requires_grad_(True)
            leaves[f"fields.{name}.{i}.weight"] = wt
            leaves[f"fields.{name}.{i}.bias"] = b
            w[name].append((wt, b))
    start = {k: v.detach().clone() for k, v in leaves.items()}
    names = list(leaves)
    n_mvs = len(mvs)
    opt_m = pointnerf.Adam([leaves[k] for k in names[:n_mvs]], m["mvs_lr"],
                           1.0, 1)
    opt_f = pointnerf.Adam([leaves[k] for k in names[n_mvs:]],
                           tr["lr_fields"], tr["lr_decay_exp"],
                           max(tr["lr_decay_iters"], 1))
    near, far = float(cam["near"]), float(cam["far"])
    out = {k: [] for k in ("loss", "rows", "found", "valid", "valid_own")}
    out["grad1"] = None
    for s, b in enumerate(batches):
        gen = generate(p, b["images"], b["K"], b["w2c"], b["c2w"], near, far,
                       b["noise"], m["num_depth"], m["dprob_thresh"],
                       m["premlp_layers"], precision,
                       None if ring_valid is None else ring_valid[s])
        if s == 0:
            out.update(xyz=gen["xyz"].detach(), ring=gen["ring"])
        out["valid"].append(gen["valid"])
        out["valid_own"].append(gen["valid_own"])
        grid = grid_on(gen["xyz"].detach(), gen["valid"], q)
        attrs = {"emb": gen["emb"], "color": gen["color"], "dir": gen["dir"],
                 "conf": gen["conf"]}
        loss, rows, found = pointnerf.train_forward(
            w, attrs, gen["xyz"], grid, b["campos"], b["camrot"], b["rd"],
            b["gt"], b["jitter_u"], near, far, rcfg, precision)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves.values(), grads)]
        if out["grad1"] is None:
            out["grad1"] = {k: g.detach().clone()
                            for k, g in zip(names, grads)}
        opt_m.step(grads[:n_mvs])
        opt_f.step(grads[n_mvs:])
        out["loss"].append(float(loss.detach()))
        out["rows"].append(rows)
        out["found"].append(found)
    out["change"] = {k: v.detach() - start[k] for k, v in leaves.items()}
    return out
