"""The per-scene fine-tuning loop.

Port of `pointnerf2studio_tpu/train/loop.py` on a dense grid: build the
grid, then either (TrainConfig.fast_path) the geometry cache and the
jitter-aware march plan (TrainConfig.march_auto) for steps of
`models/fast_train.make_fast_train_step`, or (the reference's default)
the grid's candidate cache (QueryConfig.use_cache) for steps of the
legacy `train/trainer.make_train_step`; the steps take ray batches
sampled on the device (TrainConfig.device_sampling, from a
`torch.Generator` on the device) or on the host
(`data/blender.PixelSampler`), with the loss log of
`utils/logger.Logger`. A step reads nothing back to the host; the log
reads each window back once. The candidate cache is built for the
legacy step only: the fast step never reads it.

Not ported, each raising NotImplementedError that names its ROADMAP
item: sharding (`mesh`), the hash grid, pruning (`prune_iter`), point
growing (`prob_freq`), evaluation (`eval_dataset`, `eval_freq`),
checkpoints (`save_freq > 0`, `resume` with a checkpoint on disk; the
port writes none), the plane background and tensorboard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.data.blender import BlenderDataset, PixelSampler
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.fast_train import (
    make_fast_train_step, make_geo_scene)
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.grid import build_grid_from_points
from pointnerf2studio_torch.ops.march import build_march_table, plan_march
from pointnerf2studio_torch.train.trainer import (
    TrainState, create_train_state, make_train_step)
from pointnerf2studio_torch.utils.logger import Logger


@dataclasses.dataclass
class FitResult:
    state: TrainState
    out_dir: str
    # one record per log window ({"step", "it_per_sec", losses...})
    log: list = dataclasses.field(default_factory=list)


def _unported(cfg: PointNerfConfig, out_dir: str, mesh, eval_dataset,
              eval_freq: int, save_freq: int, resume: bool,
              tensorboard: bool) -> None:
    t = cfg.train
    ckpt = os.path.join(out_dir, "ckpt")
    checks = [
        (mesh is not None, "sharded training (mesh)", 12),
        (cfg.query.grid_mode == "hash", "the hash grid", 9),
        (t.prune_iter > 0, "pruning (prune_iter)", 8),
        (t.prob_freq > 0, "point growing (prob_freq)", 8),
        (eval_dataset is not None or eval_freq > 0,
         "evaluation (eval_dataset, eval_freq)", 8),
        (save_freq > 0, "checkpoints (save_freq)", 8),
        (resume and os.path.isdir(ckpt) and bool(os.listdir(ckpt)),
         "resuming from a checkpoint", 8),
        (cfg.bgmodel.endswith("plane"), "the plane background", 9),
        (tensorboard, "tensorboard", 10),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"fit: {what} is not ported (ROADMAP queue 1 item {item})")


def plan_train_march(cfg: PointNerfConfig, dataset: BlenderDataset,
                     grid) -> PointNerfConfig:
    """`cfg` with march_steps / march_buckets planned from the scene's
    cameras, as the reference's fit() plans them (march_auto): rays of up
    to 4 views (every 13th pixel, at most 8192 a view) simulated on the
    host with the jittered walk, fuel x 1.5 + 4, buckets rescaled to
    rays_per_batch with 20% slack."""
    q = cfg.query
    occ = grid.coor_occ
    tbl = build_march_table(torch.where(occ, 0, -1)).cpu().numpy()
    vs = list(range(dataset.num_views))[::max(dataset.num_views // 4, 1)][:4]
    rays_l, orig_l = [], []
    for v in vs:
        rv = dataset.full_image_rays(v)[::13][:8192]
        rays_l.append(rv)
        orig_l.append(np.broadcast_to(
            np.asarray(dataset.campos(v), np.float32), rv.shape))
    capm = min(q.SR, q.ray_slot_budget or q.SR, q.z_depth_dim)
    block_lens = tuple(rv.shape[0] for rv in rays_l)
    steps, buckets = plan_march(
        tbl, grid.ranges_min.cpu().numpy(), q.scaled_vsize,
        np.concatenate(orig_l, 0), np.concatenate(rays_l, 0),
        float(dataset.near), float(dataset.far), q.z_depth_dim, capm,
        slack=1.3, jitter=float(cfg.train.jitter), block_lens=block_lens)
    steps = tuple(int(s * 1.5) + 4 for s in steps)
    rb = cfg.train.rays_per_batch
    bl0 = max(block_lens)
    buckets = tuple(min(rb, (int(b * rb / bl0 * 1.2) + 255) // 256 * 256
                        + 256) for b in buckets)
    return dataclasses.replace(cfg, query=dataclasses.replace(
        q, march_steps=steps, march_buckets=buckets))


class DeviceSampler:
    """Ray batches drawn on the device (the reference's `_dev_sample`):
    one view and `rays_per_batch` integer pixels of it per step, from a
    `torch.Generator` on the device. Images and poses are uploaded once."""

    def __init__(self, dataset: BlenderDataset, rays_per_batch: int,
                 generator: torch.Generator, with_mask: bool = False):
        dev = generator.device
        self.g = generator
        self.B = rays_per_batch
        self.V = dataset.num_views
        self.H, self.W = dataset.hw
        intr = np.asarray(dataset.intrinsics, np.float64)
        self.fx, self.fy = float(intr[0, 0]), float(intr[1, 1])
        self.cx, self.cy = float(intr[0, 2]), float(intr[1, 2])
        self.imgs = torch.as_tensor(dataset.images, dtype=torch.float32,
                                    device=dev)
        self.campos = torch.as_tensor(np.stack(
            [dataset.campos(v) for v in range(self.V)]), dtype=torch.float32,
            device=dev)
        self.camrot = torch.as_tensor(np.stack(
            [dataset.camrotc2w(v) for v in range(self.V)]),
            dtype=torch.float32, device=dev)
        self.alphas = (torch.as_tensor(dataset.alphas, dtype=torch.float32,
                                       device=dev) if with_mask else None)

    def next_batch(self):
        """(campos [3], camrotc2w [3, 3], raydirs [B, 3], gt_rgb [B, 3],
        gt_mask [B] bool or None), all on the device, with no read back to
        the host."""
        dev = self.g.device
        view = torch.randint(self.V, (), generator=self.g, device=dev)
        xs = torch.randint(self.W, (self.B,), generator=self.g, device=dev)
        ys = torch.randint(self.H, (self.B,), generator=self.g, device=dev)
        gt = self.imgs[view, ys, xs]
        x = (xs.to(torch.float32) + 0.5 - self.cx) / self.fx
        y = (ys.to(torch.float32) + 0.5 - self.cy) / self.fy
        camrot = self.camrot[view]
        v = torch.stack([x, y, torch.ones_like(x)], -1)
        dirs = (v[:, None, :] * camrot[None]).sum(-1)          # v @ camrot.T
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-5)
        gtm = None if self.alphas is None else self.alphas[view, ys, xs] > 0
        return self.campos[view], camrot, dirs, gt, gtm


def fit(
    cfg: PointNerfConfig,
    dataset: BlenderDataset,
    params: Aggregator,
    points: NeuralPointCloud,
    out_dir: str,
    max_steps: Optional[int] = None,
    eval_dataset: Optional[BlenderDataset] = None,
    print_freq: int = 100,
    save_freq: int = 0,
    eval_freq: int = 0,
    mesh=None,
    seed: int = 0,
    resume: bool = True,
    tensorboard: bool = False,
    device: torch.device | str | None = None,
) -> FitResult:
    """Fine-tune `params` and the trainable attributes of `points` on
    `dataset` (both are copied into the train state; the caller's objects
    stay as they are). Runs on `device` (None: the card; raises without
    one), to which `points` and `params` must already belong. Returns the
    final state and one log record per `print_freq` window."""
    device = resolve_device(device)
    _unported(cfg, out_dir, mesh, eval_dataset, eval_freq, save_freq,
              resume, tensorboard)
    if points.xyz.device.type != device.type:
        raise ValueError(f"points are on {points.xyz.device}, fit runs on "
                         f"{device}")
    logger = Logger(out_dir)
    max_steps = max_steps or cfg.train.max_iterations
    t = cfg.train
    state = create_train_state(params, points, cfg)
    q = cfg.query
    grid = build_grid_from_points(
        state.points.xyz, state.points.alive,
        dataclasses.replace(q, use_cache=q.use_cache and not t.fast_path))
    if t.fast_path:
        if (t.march_auto and not q.march_steps and not cfg.inverse
                and q.compact_mode == "topk" and q.z_depth_dim <= 512):
            cfg = plan_train_march(cfg, dataset, grid)
            print(f"train march auto-plan: steps {cfg.query.march_steps} "
                  f"buckets {cfg.query.march_buckets}")
        geo, rmin, svs = make_geo_scene(cfg, state.points, grid)
        fast_step = make_fast_train_step(cfg)

        def step_fn(st, campos, camrot, rays, gt, near, far, **kw):
            return fast_step(st, geo, rmin, svs, campos, camrot, rays, gt,
                             near, far, **kw)
    else:
        legacy_step = make_train_step(cfg)

        def step_fn(st, campos, camrot, rays, gt, near, far, **kw):
            return legacy_step(st, grid, campos, camrot, rays, gt, near,
                               far, **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    need_mask = (dataset.alphas is not None
                 and any(n.startswith("ray_depth_masked_")
                         for n in t.color_loss_items))
    use_dev = t.device_sampling and t.random_sample == "random"
    if use_dev:
        sampler = DeviceSampler(dataset, t.rays_per_batch, gen, need_mask)
    else:
        sampler = PixelSampler(dataset, t.rays_per_batch, seed=seed,
                               mode=t.random_sample)
    near = torch.tensor(float(dataset.near), device=device)
    far = torch.tensor(float(dataset.far), device=device)
    log = []
    K = max(1, int(t.steps_per_dispatch)) if use_dev else 1
    step = 1
    while step <= max_steps:
        # steps_per_dispatch: the log cadence fires at the first window
        # boundary at or after its step, as in the reference; the steps
        # themselves are the same for any K
        k_eff = K if step + K - 1 <= max_steps else 1
        for _ in range(k_eff):
            if use_dev:
                campos, camrot, rays, gt, gtm = sampler.next_batch()
            else:
                b = sampler.next_batch()
                campos, camrot, rays, gt = (
                    torch.as_tensor(np.asarray(b[k], np.float32),
                                    device=device)
                    for k in ("campos", "camrotc2w", "raydirs", "gt_rgb"))
                gtm = (torch.as_tensor(b["gt_mask"], device=device)
                       if need_mask and "gt_mask" in b else None)
            state, aux = step_fn(state, campos, camrot, rays, gt, near, far,
                                 generator=gen, gt_mask=gtm)
            logger.accumulate(aux)
        s0, step = step, step + k_eff
        s_end = step - 1
        if print_freq and (s_end // print_freq) > ((s0 - 1) // print_freq):
            log.append(logger.flush(
                s_end, extra={"n_points": int(state.points.num_alive)}))
    return FitResult(state=state, out_dir=out_dir, log=log)
