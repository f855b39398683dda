"""The per-scene fine-tuning loop.

Port of `pointnerf2studio_tpu/train/loop.py`: build the grid of
QueryConfig.grid_mode (ops/hash_grid.build_query_grid: the dense grid,
or the sparse hash grid of large-extent scenes), then either
(TrainConfig.fast_path) the geometry cache and, on a dense grid, the
jitter-aware march plan (TrainConfig.march_auto) for steps of
`models/fast_train.make_fast_train_step`, or (the reference's default)
the grid's candidate cache (QueryConfig.use_cache) for steps of the
legacy `train/trainer.make_train_step`. The hash grid serves the fast
step only: as in the reference, it refuses the legacy step and point
growing (both read dense tables) and evaluates through the fast
renderer. With `bgmodel="plane"` the plane model's background maps
(models/bg_plane.create_all_bg) are made once, and each batch takes its
pixels' background colours from them. The steps take ray batches
sampled on the device (TrainConfig.device_sampling, from a
`torch.Generator` on the device) or on the host
(`data/blender.PixelSampler`), with the loss log of
`utils/logger.Logger`. A step reads nothing back to the host; the log
reads each window back once. The candidate cache is built for the
legacy step only: the fast step never reads it.

Between steps, on the reference's cadences (reference
pointnerf/run/train_ft.py:834-923): pruning (`prune_iter`: points under
`prune_thresh` die, the grid and the step's cache are rebuilt, the stale
cache freed first), point growing (`prob_freq`: the views that the
`ray_miss_*` loss ranks worst are probed, `train/grow.probe_and_grow`,
and the caches rebuilt), the native checkpoint (`save_freq`, and once
at the end; `utils/checkpoint_io.py`) and evaluation (`eval_freq` on
`eval_dataset`, through the legacy renderer, or on a hash grid the fast
one). `resume` restores the
latest native checkpoint and goes on from the step after it; a finished
run returns without a step. The sampling generator restarts at `seed`
on resume, as the reference's PRNG key does. A device out-of-memory
error raises (the reference's sleep-and-retry is not ported).

Not ported, each raising NotImplementedError that names its ROADMAP
item: sharding (`mesh`) and tensorboard.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.data.blender import BlenderDataset, PixelSampler
from pointnerf2studio_torch.models import neural_points as npts
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.bg_plane import create_all_bg
from pointnerf2studio_torch.models.fast_train import (
    make_fast_train_step, make_geo_scene, make_hash_geo_scene)
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.hash_grid import HashGrid, build_query_grid
from pointnerf2studio_torch.ops.march import build_march_table, plan_march
from pointnerf2studio_torch.train.evaluator import evaluate_dataset
from pointnerf2studio_torch.train.grow import probe_and_grow
from pointnerf2studio_torch.train.trainer import (
    TrainState, create_train_state, make_train_step)
from pointnerf2studio_torch.utils import checkpoint_io as cio
from pointnerf2studio_torch.utils.logger import Logger

MISS_LOSS = "ray_miss_coarse_raycolor_loss"


@dataclasses.dataclass
class FitResult:
    state: TrainState
    out_dir: str
    # the final evaluation's mean metrics (empty without eval_dataset)
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    # one record per log window ({"step", "it_per_sec", losses...})
    log: list = dataclasses.field(default_factory=list)
    # one entry per evaluation: {"step", "wall_s", "psnr", ...}
    eval_history: list = dataclasses.field(default_factory=list)
    # one entry per growth event: {"step", "grown_points", "n_alive"}
    grow_history: list = dataclasses.field(default_factory=list)

    def time_to_psnr(self, target_db: float):
        """(step, wall_s) of the first evaluation at or above `target_db`,
        or None; wall_s counts from fit()'s start."""
        for rec in self.eval_history:
            if rec.get("psnr", 0.0) >= target_db:
                return rec["step"], rec["wall_s"]
        return None


def _unported(cfg: PointNerfConfig, mesh, tensorboard: bool) -> None:
    checks = [
        (mesh is not None, "sharded training (mesh)", 12),
        (tensorboard, "tensorboard", 10),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"fit: {what} is not ported (ROADMAP queue 1 item {item})")


def save_checkpoint(out_dir: str, state: TrainState, step: int,
                    best_psnr: float = 0.0) -> None:
    """The native checkpoint of `state` at `step`, with the reference's
    `<step>_net_ray_marching.pth` export and `<step>_states.pth` sidecar."""
    cio.save_train_state(os.path.join(out_dir, "ckpt"), state, step)
    cio.export_torch_checkpoint(
        state.params, state.points,
        os.path.join(out_dir, f"{step}_net_ray_marching.pth"))
    cio.export_states_file(os.path.join(out_dir, f"{step}_states.pth"),
                           epoch_count=0, total_steps=step,
                           best_PSNR=best_psnr)


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
        the host; `self.view` holds the view drawn (a device scalar),
        `self.xs` and `self.ys` its pixels."""
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
        self.view, self.xs, self.ys = view, xs, ys
        return self.campos[view], camrot, dirs, gt, gtm


def probe_views_by_miss(miss_pairs: list, n_views: int, num_views: int,
                        seed: int) -> list:
    """The views a growth event probes: the worst `n_views` by the last
    ray-miss loss each view had in `miss_pairs` ((view, loss) device
    scalars, read back here in one transfer), then views of
    `np.random.default_rng(seed).permutation(num_views)` to fill up."""
    views = []
    if miss_pairs:
        vs = torch.stack([torch.as_tensor(v) for v, _ in miss_pairs])
        ls = torch.stack([torch.as_tensor(l, dtype=torch.float32)
                          for _, l in miss_pairs])
        miss = {}
        for v, l in zip(vs.cpu().tolist(), ls.cpu().tolist()):
            miss[int(v)] = float(l)
        views = sorted(miss, key=miss.get, reverse=True)[:n_views]
    if len(views) < n_views:
        rest = [int(v) for v in np.random.default_rng(seed).permutation(
            num_views) if v not in views]
        views += rest[:n_views - len(views)]
    return views


def fit(
    cfg: PointNerfConfig,
    dataset: BlenderDataset,
    params: Aggregator,
    points: NeuralPointCloud,
    out_dir: str,
    max_steps: Optional[int] = None,
    eval_dataset: Optional[BlenderDataset] = None,
    print_freq: int = 100,
    save_freq: int = 25_000,
    eval_freq: int = 0,
    eval_views: Optional[list] = None,
    mesh=None,
    seed: int = 0,
    eval_chunk: int = 4096,
    resume: bool = True,
    tensorboard: bool = False,
    eval_save_images: bool = False,
    device: torch.device | str | None = None,
) -> FitResult:
    """Fine-tune `params` and the trainable attributes of `points` on
    `dataset` (both are copied into the train state; the caller's objects
    stay as they are), with the structure events, checkpoints and
    evaluations of the module docstring. Runs on `device` (None: the card;
    raises without one), to which `points` and `params` must already
    belong. Returns the final state, the final evaluation's metrics, one
    log record per `print_freq` window and per growth event, the
    evaluation history and the growth history."""
    device = resolve_device(device)
    _unported(cfg, mesh, tensorboard)
    if points.xyz.device.type != device.type:
        raise ValueError(f"points are on {points.xyz.device}, fit runs on "
                         f"{device}")
    logger = Logger(out_dir)
    max_steps = max_steps or cfg.train.max_iterations
    t = cfg.train
    state = create_train_state(params, points, cfg)
    t_fit0 = time.time()
    ckpt_dir = os.path.join(out_dir, "ckpt")
    start_step = 1
    if resume:
        last = cio.latest_step(ckpt_dir)
        if last is not None:
            # a finished run (last >= max_steps) restores and returns
            state = cio.restore_train_state(ckpt_dir, last, state, cfg)
            start_step = last + 1
            print(f"resumed from step {last}")
    q = cfg.query
    # the grid, the candidate cache for the legacy step only
    cfg_g = dataclasses.replace(cfg, query=dataclasses.replace(
        q, use_cache=q.use_cache and not t.fast_path))
    grid = build_query_grid(state.points.xyz, state.points.alive,
                            cfg_g.query)
    is_hash = isinstance(grid, HashGrid)
    if is_hash and not t.fast_path:
        raise ValueError(
            "grid_mode resolved to the sparse hash grid, which requires "
            "TrainConfig.fast_path=True (the legacy train step needs dense "
            "tables)")
    if is_hash and t.prob_freq > 0:
        raise ValueError(
            "point growing (prob_freq > 0) renders probes through the legacy "
            "path, which is dense-only; set prob_freq=0 for hash-grid scenes "
            "or use grid_mode='dense'")
    # the plane background: per-view maps made once, indexed per batch by
    # pixel (reference train_ft.py:604-612 and :208-211)
    bg_maps = None
    if cfg.bgmodel.endswith("plane"):
        alive = state.points.alive
        bg_maps = torch.as_tensor(create_all_bg(
            cfg, dataset, points_xyz=state.points.xyz[alive],
            device=device), device=device)

    def make_geo():
        if isinstance(grid, HashGrid):
            return make_hash_geo_scene(cfg, state.points, grid)
        return make_geo_scene(cfg, state.points, grid)

    geo = {}
    if t.fast_path:
        if (t.march_auto and not q.march_steps and not cfg.inverse
                and not is_hash and q.compact_mode == "topk"
                and q.z_depth_dim <= 512):
            cfg = plan_train_march(cfg, dataset, grid)
            print(f"train march auto-plan: steps {cfg.query.march_steps} "
                  f"buckets {cfg.query.march_buckets}")
        geo["scene"] = make_geo()
        fast_step = make_fast_train_step(cfg)

        def step_fn(st, campos, camrot, rays, gt, near, far, **kw):
            g, rmin, svs = geo["scene"]
            return fast_step(st, g, rmin, svs, campos, camrot, rays, gt,
                             near, far, **kw)
    else:
        legacy_step = make_train_step(cfg)

        def step_fn(st, campos, camrot, rays, gt, near, far, **kw):
            return legacy_step(st, grid, campos, camrot, rays, gt, near,
                               far, **kw)

    def rebuild_geo():
        if t.fast_path:
            geo.clear()         # the stale cache goes before the build
            geo["scene"] = make_geo()

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
    log, eval_history, grow_history = [], [], []
    miss_pairs: list = []       # (view, ray-miss loss) device scalars
    last_saved = -1

    def evaluate(step, **kw):
        m = evaluate_dataset(cfg, state.params, state.points, grid,
                             eval_dataset, views=eval_views,
                             chunk=eval_chunk, fast=is_hash,
                             bg_src_dataset=(dataset if bg_maps is not None
                                             else None), **kw)
        eval_history.append({"step": step,
                             "wall_s": round(time.time() - t_fit0, 1), **m})
        return m

    K = max(1, int(t.steps_per_dispatch)) if use_dev else 1
    step = start_step
    while step <= max_steps:
        # steps_per_dispatch: the cadences fire at the first window
        # boundary at or after their step, as in the reference; the steps
        # themselves are the same for any K
        k_eff = K if step + K - 1 <= max_steps else 1
        for _ in range(k_eff):
            if use_dev:
                campos, camrot, rays, gt, gtm = sampler.next_batch()
                view = sampler.view
                bg = (None if bg_maps is None
                      else bg_maps[view, sampler.ys, sampler.xs])
            else:
                b = sampler.next_batch()
                campos, camrot, rays, gt = (
                    torch.as_tensor(np.asarray(b[k], np.float32),
                                    device=device)
                    for k in ("campos", "camrotc2w", "raydirs", "gt_rgb"))
                gtm = (torch.as_tensor(b["gt_mask"], device=device)
                       if need_mask and "gt_mask" in b else None)
                view = b["view"]
                bg = None
                if bg_maps is not None:
                    xy = torch.as_tensor(b["pixel_xy"], device=device)
                    bg = bg_maps[view, xy[:, 1], xy[:, 0]]
            state, aux = step_fn(state, campos, camrot, rays, gt, near, far,
                                 generator=gen, gt_mask=gtm, bg_rgb=bg)
            logger.accumulate(aux)
            if t.prob_freq > 0 and MISS_LOSS in aux:
                miss_pairs.append((view, aux[MISS_LOSS]))
        s0, step = step, step + k_eff
        s_end = step - 1

        def crossed(freq):
            return freq and (s_end // freq) > ((s0 - 1) // freq)

        if crossed(print_freq):
            log.append(logger.flush(
                s_end, extra={"n_points": int(state.points.num_alive)}))

        # prune low-confidence points, rebuild the grid and the step's
        # cache (reference train_ft.py:834-842)
        if (t.prune_iter > 0 and crossed(t.prune_iter)
                and s0 <= t.prune_max_iter):
            state.points = npts.prune(state.points, t.prune_thresh)
            grid = None         # the stale grid goes before the build
            grid = build_query_grid(state.points.xyz, state.points.alive,
                                    cfg_g.query)
            rebuild_geo()

        # probe holes and grow points (reference train_ft.py:844-923)
        if t.prob_freq > 0 and crossed(t.prob_freq):
            views = probe_views_by_miss(
                miss_pairs, max(1, dataset.num_views // t.prob_num_step),
                dataset.num_views, s_end)
            miss_pairs.clear()
            state, grid, n_new = probe_and_grow(
                cfg_g, state, grid, dataset, views=views, chunk=eval_chunk,
                opacity_thresh=t.prob_thresh, prob_mul=t.prob_mul)
            if n_new:
                rebuild_geo()
            grow_history.append({"step": s_end, "grown_points": int(n_new),
                                 "n_alive": int(state.points.num_alive)})
            log.append(logger.flush(s_end, extra={"grown_points": n_new}))

        if save_freq and crossed(save_freq):
            save_checkpoint(out_dir, state, s_end)
            last_saved = s_end

        if crossed(eval_freq) and eval_dataset is not None:
            m = evaluate(
                s_end, save_images=eval_save_images,
                out_dir=(os.path.join(out_dir, f"evalimg_{s_end:06d}")
                         if eval_save_images else None))
            log.append(logger.flush(
                s_end, extra={f"eval_{k}": v for k, v in m.items()}))

    if last_saved != max_steps:
        # the cadence save may have written this step already
        save_checkpoint(out_dir, state, max_steps)
    metrics: Dict[str, float] = {}
    if eval_dataset is not None:
        metrics = evaluate(max_steps)
        log.append(logger.flush(
            max_steps, extra={f"final_{k}": v for k, v in metrics.items()}))
    return FitResult(state=state, out_dir=out_dir, metrics=metrics, log=log,
                     eval_history=eval_history, grow_history=grow_history)
