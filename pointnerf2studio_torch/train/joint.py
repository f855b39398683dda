"""Joint MVS + Point-NeRF training (the reference's `opt.mode == 0`).

Port of `pointnerf2studio_tpu/train/joint.py`. Feedforward mode: every
step regenerates the neural point cloud from the current MVS networks
(learned depth probability, `manual_depth_view=-1`) and renders through
it, so gradients flow from the photometric loss back through the point
embeddings into FeatureNet / CostRegNet / ProbNet / premlp (reference:
pointnerf/models/mvs_points_volumetric_model.py:38-45 mode 0;
mvs_points_model.py:261-340 gen_points with manual_depth_view == -1; a
third Adam group `--mvs_lr 5e-4`, mvs_points_model.py:79).

The generated cloud has H/4 * W/4 candidate points (one per ref-view
feature pixel), with a validity mask from the prob_filter; the voxel
grid is rebuilt every step on the detached positions (the reference also
rebuilds its grid every forward, point_query.py:86-93), and the step
renders through the legacy `models/render.render_rays`, whose compaction
launches `first_valid_cols` once a step on the card.

Gradient paths (torch autograd through the same code as the reference):
loss -> rendered colour -> point embedding/colour/dir/conf -> premlp and
the FPN feature samples, and -> point xyz -> aggregation distances and
weights -> the expected depth -> ProbNet and CostRegNet. Selections (the
prob_filter mask, the K-NN, the grid) carry none.

Two Adam groups as the reference's joint step has them: `mvs_lr` (no
decay) on every parameter of `MvsParams` - BatchNorm's stored mean and
variance included, which the JAX tree holds as leaves beside scale and
bias - and the fields with lr_fields * lr_decay_exp ** (n /
lr_decay_iters) (optax's exponential_decay, staircase off).

Tracing (`utils/profiling.py`; all of it acts only while a torch.profiler
session records): the counters `joint.steps` and `joint.points_generated`
(H/4 * W/4 a step, known on the host), and the span `joint.step`
(`step=<n>`) holding the phases `joint.features`, `joint.cost_volume`,
`joint.cost_reg`, `joint.points`, `joint.grid`, `joint.render`,
`joint.loss`, `joint.backward` and `joint.optimizer`.

The noise draws are arguments: `generate_points_diff` takes the gaussian
depth draw `noise` [h, w] and the step the render's `jitter_u` [R, D]; a
step given neither draws both from its `torch.Generator`. On the card the
backward of the gathers accumulates with atomics, so two runs of a step
agree within rounding, not bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.mvsnet.costvol import (
    CostVolParams, build_cost_volume, cost_reg_net8, depth_values_linear,
    expected_depth_std, init_costvol_params, init_fpn_params,
    init_premlp_params, prob_net)
from pointnerf2studio_torch.models.mvsnet.featurenet import (
    FeatureNet, fpn_features, load_fpn_params, make_premlp)
from pointnerf2studio_torch.models.mvsnet.layers import bilinear_grid_sample
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.models.render import render_rays
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.grid import build_grid
from pointnerf2studio_torch.train.loss import compute_losses
from pointnerf2studio_torch.utils import profiling


class MvsParams(nn.Module):
    """The trainable MVS stack (the reference's net_mvs): `FeatureNet`
    and `premlp` under `best_net_mvs.pth`'s names, and `costvol`
    (CostRegNet + ProbNet). `fpn` is the FeatureNet."""

    def __init__(self, num_views: int = 3, premlp_layers: int = 1):
        super().__init__()
        self.FeatureNet = FeatureNet()
        self.premlp = make_premlp(premlp_layers)
        self.costvol = CostVolParams(num_views)

    @property
    def fpn(self) -> FeatureNet:
        return self.FeatureNet


@dataclasses.dataclass
class JointState:
    mvs: MvsParams
    fields: Aggregator
    opt_mvs: torch.optim.Adam
    opt_fields: torch.optim.Adam
    sched_fields: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


class MVSTrainBatch(NamedTuple):
    """One joint step's device batch."""
    images: torch.Tensor        # [V, H, W, 3] ref view first
    intrinsics: torch.Tensor    # [V, 3, 3] full-res
    w2cs: torch.Tensor          # [V, 4, 4]
    c2ws: torch.Tensor          # [V, 4, 4]
    near_far: torch.Tensor      # [2] scene depth range of the ref view
    # ray supervision (sampled from the ref or another train view)
    campos: torch.Tensor        # [3]
    camrotc2w: torch.Tensor     # [3, 3]
    raydirs: torch.Tensor       # [R, 3]
    gt_rgb: torch.Tensor        # [R, 3]


def init_joint_params(seed: int = 0, num_views: int = 3,
                      premlp_layers: int = 1,
                      device: torch.device | str | None = None) -> MvsParams:
    """A fresh MVS stack, xavier-uniform from a CPU generator seeded with
    `seed` (the FPN, then the premlp with ReLU gain on all but its last
    Linear, then the cost-volume nets), on `device` (None: the card)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    p = MvsParams(num_views, premlp_layers)
    p.FeatureNet = init_fpn_params(g, device="cpu")
    p.premlp = init_premlp_params(g, num_layers=premlp_layers, device="cpu")
    p.costvol = init_costvol_params(g, num_views, device="cpu")
    return p.to(dev)


def load_pretrained_joint_params(seed: int, best_net_mvs_path: str,
                                 num_views: int = 3,
                                 device: torch.device | str | None = None
                                 ) -> MvsParams:
    """The joint stack seeded from `best_net_mvs.pth`, as the reference
    fine-tunes mode 0 (train_ft.py resumes net_mvs; mvs_points_model.py:
    79): FeatureNet and premlp from the file (a fresh one-layer premlp
    where it has none), CostRegNet / ProbNet fresh, since the DTU init
    does not carry them."""
    dev = resolve_device(device)
    fpn = load_fpn_params(best_net_mvs_path, device=dev)
    fresh = init_joint_params(seed, num_views=num_views, device=dev)
    if hasattr(fpn, "premlp"):
        fresh.premlp = fpn.premlp
    fresh.FeatureNet = fpn.FeatureNet
    return fresh


def generate_points_diff(
    mvs: MvsParams,
    images: torch.Tensor,       # [V, H, W, 3]
    intrinsics: torch.Tensor,   # [V, 3, 3]
    w2cs: torch.Tensor,         # [V, 4, 4]
    c2ws: torch.Tensor,         # [V, 4, 4]
    near_far: torch.Tensor,     # [2]
    noise: Optional[torch.Tensor] = None,
    num_depth: int = 128,
    std_depth: float = 0.0,
    dprob_thresh: float = 0.8,
) -> Dict[str, torch.Tensor]:
    """Differentiable point generation for the ref view (vid 0): xyz
    [N, 3] (world), embedding [N, C], color / dir [N, 3], conf [N, 1],
    valid [N], N = (H/4) * (W/4). gen_points(manual_depth_view=-1) +
    query_embedding (mvs_points_model.py:141-167,224-258,261-340) with
    pad 0. `noise` [h, w] standard-normal draws sample the depth with the
    learned per-pixel std (gau_single_sampler); None samples the
    expectation."""
    V, H, W, _ = images.shape
    h, w = H // 4, W // 4
    near, far = near_far[0], near_far[1]
    dev = images.device

    with profiling.span("joint.features"):
        feats_all = fpn_features(mvs.fpn, images)               # batched
    feats_top = feats_all[3]                                    # [V,h,w,32]

    with profiling.span("joint.cost_volume"):
        # quarter-res projection matrices, src @ inv(ref)
        Kq = intrinsics.clone()
        Kq[:, :2, :] = Kq[:, :2, :] * 0.25
        proj = torch.eye(4, device=dev).repeat(V, 1, 1)
        proj[:, :3, :4] = Kq @ w2cs[:, :3, :4]
        proj = proj @ torch.linalg.inv(proj[0])
        imgs_q = images.reshape(V, h, 4, w, 4, 3).mean((2, 4))
        vol = build_cost_volume(
            imgs_q, feats_top, proj,
            depth_values_linear(near, far, num_depth, dev), vid=0, pad=0)
    # costvol.depth_probability's two halves, each its own span
    with profiling.span("joint.cost_reg"):
        prob = prob_net(mvs.costvol.probnet,
                        cost_reg_net8(mvs.costvol.costreg, vol))
    with profiling.span("joint.points"):
        ndc_e, ndc_std, valid = expected_depth_std(prob, dprob_thresh)

        ndc_z = ndc_e + ndc_std * noise if noise is not None else ndc_e
        ndc_z = torch.clamp(ndc_z, 0.0, 1.0)

        # unproject at feature-resolution pixels scaled to full-res coords
        # (depth2point: normalised [0, 1] pixel coords * (W - 1),
        # mvs_points_model.py:170-181)
        f32 = torch.float32
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=f32, device=dev) / (h - 1) * (H - 1),
            torch.arange(w, dtype=f32, device=dev) / (w - 1) * (W - 1),
            indexing="ij")
        cam_z = ndc_z * (far - near) + near
        pix = torch.stack([xx * cam_z, yy * cam_z, cam_z], -1)   # [h, w, 3]
        Kinv_t = torch.linalg.inv(intrinsics[0]).T
        cam_xyz = pix.reshape(-1, 3) @ Kinv_t                    # [N, 3]

        c2w0 = c2ws[0]
        xyz_w = cam_xyz @ c2w0[:3, :3].T + c2w0[:3, 3]

        # embedding: imgfeat_0_0123 / dir_0 / point_conf via the ref view
        pix_xy = (cam_xyz / cam_xyz[:, 2:3]) @ intrinsics[0].T
        xy = pix_xy[:, :2]
        lim = torch.tensor([W - 1, H - 1], dtype=xy.dtype, device=dev)
        inb = ((xy >= 0) & (xy <= lim)).all(-1)
        gx = xy[:, 0] / ((W - 1) / 2.0) - 1.0
        gy = xy[:, 1] / ((H - 1) / 2.0) - 1.0
        grid2 = torch.stack([gx, gy], -1)
        sampled = [bilinear_grid_sample(f[0], grid2, align_corners=True)
                   * inb[:, None] for f in feats_all]
        colors = sampled[0]
        emb_feats = torch.cat(sampled[1:], -1)                   # [N, 56]

        dirs = cam_xyz / (torch.linalg.norm(cam_xyz, dim=-1, keepdim=True)
                          + 1e-6)
        dirs_w = dirs @ c2w0[:3, :3].T

        # mode -1: no photometric confidence
        conf = torch.ones_like(colors[:, :1])
        embedding = mvs.premlp(torch.cat([emb_feats, colors, dirs_w, conf],
                                         -1))

        valid = valid.reshape(-1) & inb & (cam_z.reshape(-1) > 0)
    return {"xyz": xyz_w, "embedding": embedding, "color": colors,
            "dir": dirs_w, "conf": conf, "valid": valid}


def render_generated(cfg: PointNerfConfig, gen: Dict[str, torch.Tensor],
                     fields: Aggregator, batch: MVSTrainBatch,
                     ranges_min: np.ndarray,
                     grid_dims: Tuple[int, int, int],
                     jitter_u: Optional[torch.Tensor] = None):
    """The second half of the joint loss: the generated cloud `gen`
    rendered through `render_rays(training=True)` on a grid built over
    its detached positions, and the losses -> (total, aux). xyz stays in
    the graph: the photometric loss reaches the depth stack only through
    point positions -> aggregation distances."""
    q = cfg.query
    dev = gen["xyz"].device
    points = NeuralPointCloud(
        xyz=gen["xyz"], points_embeding=gen["embedding"],
        points_conf=gen["conf"], points_dir=gen["dir"],
        points_color=gen["color"], Rw2c=torch.eye(3, device=dev),
        alive=gen["valid"])
    with profiling.span("joint.grid"):
        grid = build_grid(
            gen["xyz"].detach(), gen["valid"],
            torch.as_tensor(np.asarray(ranges_min, np.float32), device=dev),
            torch.as_tensor(np.asarray(q.scaled_vsize, np.float32),
                            device=dev),
            tuple(grid_dims), q.max_o, q.P, q.query_size)
    with profiling.span("joint.render"):
        out = render_rays(fields, points, grid, batch.campos,
                          batch.camrotc2w, batch.raydirs, batch.near_far[0],
                          batch.near_far[1], cfg, training=True,
                          jitter_u=jitter_u)
    with profiling.span("joint.loss"):
        total, aux = compute_losses(out, batch.gt_rgb, cfg.train)
    aux["n_valid"] = gen["valid"].sum()
    return total, aux


def make_joint_loss_fn(
    cfg: PointNerfConfig,
    ranges_min: np.ndarray,
    grid_dims: Tuple[int, int, int],
    num_depth: int = 128,
    dprob_thresh: float = 0.8,
) -> Callable:
    """loss_fn(mvs, fields, batch, noise=None, jitter_u=None) -> (total,
    aux): `generate_points_diff`, then `render_generated`; aux holds the
    loss parts and `n_valid`, the generated points the prob_filter let
    through."""

    def loss_fn(mvs, fields, batch: MVSTrainBatch,
                noise: Optional[torch.Tensor] = None,
                jitter_u: Optional[torch.Tensor] = None):
        gen = generate_points_diff(
            mvs, batch.images, batch.intrinsics, batch.w2cs, batch.c2ws,
            batch.near_far, noise=noise, num_depth=num_depth,
            dprob_thresh=dprob_thresh)
        return render_generated(cfg, gen, fields, batch, ranges_min,
                                grid_dims, jitter_u)

    return loss_fn


def _lr_lambda(cfg: PointNerfConfig):
    t = cfg.train
    return lambda n: t.lr_decay_exp ** (n / t.lr_decay_iters)


def make_joint_train_step(
    cfg: PointNerfConfig,
    ranges_min: np.ndarray,
    grid_dims: Tuple[int, int, int],
    mvs_lr: float = 5e-4,
    num_depth: int = 128,
    dprob_thresh: float = 0.8,
) -> Callable:
    """step(state, batch, generator=None, noise=None, jitter_u=None) ->
    aux: one joint step in place (forward, backward, both Adam groups).
    The depth draw `noise` [H/4, W/4] and the render's `jitter_u` [R, D]
    come from the arguments where given, else from `generator`; with
    neither, the step samples the expected depth and the unjittered
    segments. The grid geometry (`ranges_min`, `grid_dims`) is fixed
    ahead, as in the reference."""
    loss_impl = make_joint_loss_fn(cfg, ranges_min, grid_dims,
                                   num_depth=num_depth,
                                   dprob_thresh=dprob_thresh)
    q = cfg.query

    def joint_step(state: JointState, batch: MVSTrainBatch,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   jitter_u: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        V, H, W, _ = batch.images.shape
        if generator is not None:
            dev = generator.device
            if noise is None:
                noise = torch.randn((H // 4, W // 4), generator=generator,
                                    device=dev)
            if jitter_u is None and cfg.train.jitter > 0.0:
                jitter_u = torch.rand((batch.raydirs.shape[0],
                                       q.z_depth_dim), generator=generator,
                                      device=dev)
        profiling.count("joint.steps")
        profiling.count("joint.points_generated", (H // 4) * (W // 4))
        with profiling.span("joint.step", f"step={state.step}"):
            state.opt_mvs.zero_grad(set_to_none=True)
            state.opt_fields.zero_grad(set_to_none=True)
            total, aux = loss_impl(state.mvs, state.fields, batch, noise,
                                   jitter_u)
            with profiling.span("joint.backward"):
                total.backward()
            with profiling.span("joint.optimizer"):
                for g in state.opt_mvs.param_groups:
                    g["lr"] = mvs_lr
                state.opt_mvs.step()
                state.opt_fields.step()
                state.sched_fields.step()
            state.step += 1
        return {k: v.detach() for k, v in aux.items()}

    return joint_step


def create_joint_state(fields: Aggregator, cfg: PointNerfConfig,
                       num_views: int = 3, mvs_lr: float = 5e-4,
                       mvs: Optional[MvsParams] = None, seed: int = 0,
                       device: torch.device | str | None = None
                       ) -> JointState:
    """A joint state owning copies of `fields` and of `mvs` (a fresh
    stack from `seed` on `device` where None), with gradients on, and
    their two Adam groups."""
    if mvs is None:
        mvs = init_joint_params(seed, num_views=num_views, device=device)
    mvs = copy.deepcopy(mvs).requires_grad_(True)
    fields = copy.deepcopy(fields).requires_grad_(True)
    t = cfg.train
    opt_m = torch.optim.Adam(mvs.parameters(), lr=mvs_lr,
                             betas=(0.9, 0.999), eps=1e-8)
    opt_f = torch.optim.Adam(fields.parameters(), lr=t.lr_fields,
                             betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt_f, _lr_lambda(cfg))
    return JointState(mvs=mvs, fields=fields, opt_mvs=opt_m,
                      opt_fields=opt_f, sched_fields=sched)
