"""Point growing: probe rendered frames for holes, add points there.

Port of `pointnerf2studio_tpu/train/grow.py` (the reference's
`probe_hole`, pointnerf/run/train_ft.py:417-530): render a probe view in
prob mode, find the pixels the model missed (ray_mask false) where the
ground truth is not background, dilate that miss mask by one pixel, and
at the neighbouring HIT pixels whose max shading opacity passes the
threshold spawn a point at the max-opacity sample location, with the
conf-weighted neighbour averages there. New points fill dead slots (the
capacity grows when they do not fit), the grown slots' Adam moments are
zeroed, and the grid is rebuilt.

The probe renders through one of two routes, chosen by the caller:
`probe="fast"` (the reference's default) through `fast_render_rays(...,
prob=True)` on a fat cache built once per growth event
(`make_probe_scene`, config `probe_cfg`), `probe="legacy"` through
`render_rays(prob=True)`. There is no switch by environment variable and
no second route when the first fails: a failure raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.data.blender import BlenderDataset
from pointnerf2studio_torch.models import neural_points as npts
from pointnerf2studio_torch.models.fast_render import (
    PROB_FIELDS, fast_render_rays, make_fast_scene)
from pointnerf2studio_torch.models.render import render_rays
from pointnerf2studio_torch.ops.grid import PointGrid, build_grid_from_points
from pointnerf2studio_torch.train.trainer import (
    TrainState, expand_state_capacity, reset_point_opt_slots, set_points)

MAPS = ("ray_mask",) + PROB_FIELDS


def _dilate1(mask: torch.Tensor) -> torch.Tensor:
    """Binary dilation of an [H, W] bool mask by one pixel (4-neighbour)."""
    out = mask.clone()
    out[1:] |= mask[:-1]
    out[:-1] |= mask[1:]
    out[:, 1:] |= mask[:, :-1]
    out[:, :-1] |= mask[:, 1:]
    return out


def probe_cfg(cfg: PointNerfConfig) -> PointNerfConfig:
    """The fast probe's config: the plain topk-packed chunk pipeline on
    the XLA route (the only route with prob outputs) with every front-end
    reducer stripped (their budgets were sized for training batches, not
    for raster-order full-image chunks) and compact_budget at the per-ray
    slot cap, so that no slot can overflow M."""
    q = cfg.query
    BP = q.ray_slot_budget or min(q.SR, 32)
    return dataclasses.replace(cfg, query=dataclasses.replace(
        q, march_steps=(), march_buckets=(), ray_budget=0, span_tiers=(),
        span_tier_budgets=(), depth_window=0, coarse_step=0,
        knn_mode="xla", chunk_mode="xla", decode_mode="lanes",
        extract_mode="onehot", compact_budget=min(q.SR, BP),
        use_cache=False))


def make_probe_scene(cfg: PointNerfConfig, points, grid, params=None):
    """(cfg_p, cache, ranges_min, scaled_vsize) for the fast probe: one
    fat cache a growth event, shared by every probe view (`params` builds
    a base_cache config's table)."""
    cfg_p = probe_cfg(cfg)
    cache, rmin, svs = make_fast_scene(cfg_p, points, grid, params=params)
    return cfg_p, cache, rmin, svs


@torch.no_grad()
def probe_view(cfg: PointNerfConfig, params, points, grid,
               dataset: BlenderDataset, view: int, chunk: int = 4096,
               opacity_thresh: float = 0.7, prob_mul: float = 1.0,
               bg_eps: float = 0.002, fast_scene=None
               ) -> Dict[str, torch.Tensor]:
    """Probe one view: the candidate points (xyz, embedding, color, dir,
    conf [.., 1] times `prob_mul`) on the device, possibly none. With
    `fast_scene` (from `make_probe_scene`) the probe renders through the
    fast path, else through the legacy `render_rays(prob=True)` with
    `cfg`. The seven maps stay on the device; the miss, dilation and grow
    masks are formed there, and only the chosen rows are gathered."""
    dev = points.xyz.device
    h, w = dataset.hw
    rays = torch.as_tensor(dataset.full_image_rays(view), dtype=torch.float32,
                           device=dev)
    campos = torch.as_tensor(dataset.campos(view), dtype=torch.float32,
                             device=dev)
    camrot = torch.as_tensor(dataset.camrotc2w(view), dtype=torch.float32,
                             device=dev)
    maps: Dict[str, list] = {k: [] for k in MAPS}
    for i in range(0, h * w, chunk):
        rd = rays[i:i + chunk]
        if fast_scene is not None:
            cfg_p, cache, rmin, svs = fast_scene
            out = fast_render_rays(params, points.Rw2c, cache, campos, camrot,
                                   rd, dataset.near, dataset.far, cfg_p,
                                   rmin, svs, prob=True)
        else:
            out = render_rays(params, points, grid, campos, camrot, rd,
                              dataset.near, dataset.far, cfg, prob=True)
        for k in MAPS:
            maps[k].append(getattr(out, k))
    m = {k: torch.cat(v) for k, v in maps.items()}
    gt = torch.as_tensor(dataset.images[view], dtype=torch.float32,
                         device=dev).reshape(h, w, 3)
    bg = torch.as_tensor(cfg.bg_color, dtype=torch.float32, device=dev)
    ray_mask = m["ray_mask"].reshape(h, w)
    miss = ~ray_mask & (torch.linalg.norm(gt - bg, dim=-1) > bg_eps)
    grow_mask = (ray_mask & _dilate1(miss)
                 & (m["ray_max_shading_opacity"].reshape(h, w)
                    > opacity_thresh))
    sel = torch.nonzero(grow_mask.reshape(-1)).squeeze(1)
    return {"xyz": m["ray_max_sample_loc_w"][sel],
            "embedding": m["shading_avg_embedding"][sel],
            "color": m["shading_avg_color"][sel],
            "dir": m["shading_avg_dir"][sel],
            "conf": m["shading_avg_conf"][sel] * prob_mul}


def pad_grow_count(m: int, bucket: int = 256) -> int:
    """A growth event's size rounded up to a bucket of `bucket` (the
    reference pads its candidate arrays to this count so that events
    share one compiled program)."""
    return max(bucket, -(-m // bucket) * bucket)


def probe_and_grow(
    cfg: PointNerfConfig, state: TrainState, grid: PointGrid,
    dataset: BlenderDataset, views: Optional[List[int]] = None,
    chunk: int = 4096, opacity_thresh: float = 0.7, prob_mul: float = 1.0,
    allow_expand: bool = True, capacity_round: int = 4096,
    probe: str = "fast", timings: Optional[dict] = None,
) -> Tuple[TrainState, PointGrid, int]:
    """Probe `views` (default all), grow points into free slots, zero the
    grown slots' Adam moments and rebuild the grid with cfg.query; returns
    (state, grid, number grown). `state` is changed in place.

    When the candidates exceed the free slots and `allow_expand`, the
    capacity first grows to at least double, rounded up to
    `capacity_round`, with the cloud and its moments re-padded; without
    expansion the overflow is dropped and reported. `probe` is "fast" or
    "legacy" (see the module docstring). `timings`, where given, receives
    the seconds of the probe, the growth and the grid rebuild."""
    import time
    if probe not in ("fast", "legacy"):
        raise ValueError(f"probe must be 'fast' or 'legacy', got {probe!r}")
    dev = state.points.xyz.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    views = views if views is not None else list(range(dataset.num_views))
    fast_scene = (make_probe_scene(cfg, state.points, grid, state.params)
                  if probe == "fast" else None)
    parts = [probe_view(cfg, state.params, state.points, grid, dataset, v,
                        chunk=chunk, opacity_thresh=opacity_thresh,
                        prob_mul=prob_mul, fast_scene=fast_scene)
             for v in views]
    del fast_scene      # free the probe's fat cache before the rebuild
    cand = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    m = cand["xyz"].shape[0]
    sync()
    t1 = time.perf_counter()
    if timings is not None:
        timings.update(probe_s=t1 - t0, grow_s=0.0, rebuild_s=0.0)
    if m == 0:
        return state, grid, 0

    n_alive = int(state.points.num_alive)
    free = state.points.capacity - n_alive
    if m > free:
        if allow_expand:
            new_cap = max(2 * state.points.capacity, n_alive + m)
            new_cap = -(-new_cap // capacity_round) * capacity_round
            print(f"grow: {m} candidates > {free} free slots; expanding "
                  f"capacity {state.points.capacity} -> {new_cap}")
            expand_state_capacity(state, new_cap)
        else:
            print(f"grow: DROPPING {m - free} of {m} candidates (capacity "
                  f"saturated, expansion disabled)")
    alive_before = state.points.alive
    points = npts.grow(state.points, cand["xyz"], cand["embedding"],
                       cand["conf"], cand["dir"], cand["color"],
                       torch.ones(m, dtype=torch.bool, device=dev))
    grown = torch.nonzero(points.alive & ~alive_before).squeeze(1)
    set_points(state, points)
    reset_point_opt_slots(state.opt_points, grown)
    sync()
    t2 = time.perf_counter()
    grid = build_grid_from_points(state.points.xyz, state.points.alive,
                                  cfg.query)
    sync()
    if timings is not None:
        timings.update(grow_s=t2 - t1, rebuild_s=time.perf_counter() - t2)
    return state, grid, int(grown.shape[0])
