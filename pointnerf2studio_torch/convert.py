"""Carry weights and state from the JAX reference into the port.

The JAX package keeps plain numpy-convertible trees: aggregator params
as {tower: [{"kernel": [in, out], "bias": [out]}, ...]}, and flax
dataclasses of arrays for the point cloud and the fat cache. These
functions take numpy arrays (np.asarray of each JAX leaf) and build the
port's objects, so a test can run both packages on the same weights,
the same cloud, the same grid and the same caches. Everything is built
on `device`: the card by default (`device=None`), the CPU where the
caller asks for it; without a card the default raises.
`train_state_from_jax` carries a whole train state with its Adam
moments, counts and step. `aggregator_to_jax` goes the other way: an
Aggregator's weights or gradients in the JAX tree's layout, for comparing
leaf by leaf. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from pointnerf2studio_torch.config import AggregatorConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.fast_render import PK, ROWW, FatCache
from pointnerf2studio_torch.models.fast_train import GEOW, GeoCache
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.grid import CandidateCache, PointGrid


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if dtype is torch.bfloat16:
        # numpy has no bfloat16: carry the raw 16-bit patterns
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)


@torch.no_grad()
def aggregator_from_jax(tree: Mapping[str, Any], cfg: AggregatorConfig,
                        device: torch.device | str | None = None
                        ) -> Aggregator:
    """JAX aggregator params -> Aggregator. A JAX kernel is [in, out];
    an nn.Linear weight is [out, in], so each kernel is transposed."""
    device = resolve_device(device)
    agg = Aggregator(cfg, device=device)
    for name in agg.towers:
        layers = getattr(agg, name)
        if len(tree[name]) != len(layers):
            raise ValueError(f"{name}: {len(tree[name])} layers in the tree, "
                             f"{len(layers)} in the config")
        for lin, lyr in zip(layers, tree[name]):
            w = _t(lyr["kernel"], device, torch.float32).T
            if w.shape != lin.weight.shape:
                raise ValueError(f"{name}: kernel {tuple(w.shape[::-1])} does "
                                 f"not fit Linear{tuple(lin.weight.shape)}")
            lin.weight.copy_(w)
            lin.bias.copy_(_t(lyr["bias"], device, torch.float32))
    return agg


def cloud_from_jax(cloud, device: torch.device | str | None = None
                   ) -> NeuralPointCloud:
    """A JAX NeuralPointCloud (or any object with its fields) -> port."""
    device = resolve_device(device)
    f = torch.float32
    return NeuralPointCloud(
        xyz=_t(cloud.xyz, device, f),
        points_embeding=_t(cloud.points_embeding, device, f),
        points_conf=_t(cloud.points_conf, device, f),
        points_dir=_t(cloud.points_dir, device, f),
        points_color=_t(cloud.points_color, device, f),
        Rw2c=_t(cloud.Rw2c, device, f),
        alive=_t(cloud.alive, device, torch.bool))


def grid_from_jax(grid, device: torch.device | str | None = None
                  ) -> PointGrid:
    """A JAX PointGrid as built, with its candidate cache where it has one
    (cand_pack keeps its bit-cast point ids): the port's legacy render
    queries that cache as the reference does, and the grid without one."""
    device = resolve_device(device)
    i32 = torch.int32
    cache = None
    if grid.cache is not None:
        cache = CandidateCache(
            coor_2_qslot=_t(grid.cache.coor_2_qslot, device, i32),
            cand_pack=_t(grid.cache.cand_pack, device, torch.float32),
            n_q=_t(grid.cache.n_q, device, i32))
    return PointGrid(
        ranges_min=_t(grid.ranges_min, device, torch.float32),
        scaled_vsize=_t(grid.scaled_vsize, device, torch.float32),
        coor_2_occ=_t(grid.coor_2_occ, device, i32),
        coor_occ=_t(grid.coor_occ, device, torch.bool),
        occ_2_pnts=_t(grid.occ_2_pnts, device, i32),
        occ_numpnts=_t(grid.occ_numpnts, device, i32),
        n_occ=_t(grid.n_occ, device, i32),
        occ_2_coor=_t(grid.occ_2_coor, device, i32), cache=cache)


def fat_cache_from_jax(cache, device: torch.device | str | None = None
                       ) -> FatCache:
    """A JAX FatCache in either layout -> port FatCache (one layout for
    every route). The kernel-facing layout (kmeta/kpay set): the
    channel-major kpay [max_q, PK, C] is transposed once into the
    candidate-major kcand, and its xyz planes are copied into kxyz. The
    rows layout (`rows` [max_q, C * ROWW] f32): each candidate's meta word
    becomes kmeta and its 22 bf16 pairs kcand's first PAYW channels, bit
    for bit, with kcand's zero padding after them. The march table, where
    the cache has one, comes along."""
    device = resolve_device(device)
    if cache.kmeta is not None and cache.kpay is not None:
        kmeta = _t(cache.kmeta, device, torch.int32)
        kcand = _t(cache.kpay, device, torch.bfloat16).transpose(1, 2)
    else:
        words = np.asarray(cache.rows, np.float32).view(np.int32)
        words = torch.from_numpy(words.reshape(words.shape[0], -1, ROWW)
                                 .copy()).to(device)
        kmeta = words[..., 0].contiguous()
        pay = words[..., 1:].contiguous().view(torch.bfloat16)
        kcand = torch.cat([pay, pay.new_zeros(pay.shape[:2]
                                              + (PK - pay.shape[2],))], -1)
    march_table = getattr(cache, "march_table", None)
    return FatCache(
        coor_2_qslot=_t(cache.coor_2_qslot, device, torch.int32),
        kmeta=kmeta, kcand=kcand.contiguous(),
        kxyz=kcand[..., :3].transpose(1, 2).contiguous(),
        n_q=_t(cache.n_q, device, torch.int32),
        march_table=(None if march_table is None
                     else _t(march_table, device, torch.int32)))


def geo_cache_from_jax(geo, device: torch.device | str | None = None
                       ) -> GeoCache:
    """A JAX train GeoCache (dense grid) -> port GeoCache: its rows
    [max_q, C * 4] f32 split into meta (the first word of each candidate,
    an int32 bit pattern) and rel (the other three); the march table, where
    the cache has one, comes along."""
    device = resolve_device(device)
    if getattr(geo, "coor_2_qslot", None) is None:
        raise ValueError("a hash-grid geo cache has no port counterpart")
    rows = np.asarray(geo.rows, np.float32)
    rows = rows.reshape(rows.shape[0], -1, GEOW)
    march_table = getattr(geo, "march_table", None)
    return GeoCache(
        coor_2_qslot=_t(geo.coor_2_qslot, device, torch.int32),
        meta=_t(np.ascontiguousarray(rows[..., 0]).view(np.int32), device,
                torch.int32),
        rel=_t(np.ascontiguousarray(rows[..., 1:]), device, torch.float32),
        n_q=_t(geo.n_q, device, torch.int32),
        march_table=(None if march_table is None
                     else _t(march_table, device, torch.int32)))


def aggregator_to_jax(agg: Aggregator, grad: bool = False) -> dict:
    """An Aggregator's weights (or, with `grad`, their gradients) as numpy
    arrays in the JAX tree's layout: {tower: [{"kernel": [in, out],
    "bias": [out]}, ...]}."""
    def leaf(p):
        x = p.grad if grad else p
        if x is None:
            raise ValueError("a weight has no gradient")
        return x.detach().cpu().numpy()

    return {name: [{"kernel": leaf(lin.weight).T, "bias": leaf(lin.bias)}
                   for lin in getattr(agg, name)] for name in agg.towers}


@torch.no_grad()
def train_state_from_jax(state, cfg, device: torch.device | str | None = None):
    """A JAX TrainState (params, points, opt_state_fields and
    opt_state_points as optax adam states, step) -> the port's TrainState
    of PointNerfConfig `cfg` on `device`: the same weights and cloud, each
    tensor's Adam moments from the optax `ScaleByAdamState`'s mu and nu
    (kernels transposed), its step count from the optax count, each
    scheduler at that count, and `step`."""
    from pointnerf2studio_torch.train.trainer import create_train_state
    device = resolve_device(device)
    port = create_train_state(
        aggregator_from_jax(state.params, cfg.agg, device=device),
        cloud_from_jax(state.points, device=device), cfg)

    def fill(opt, sched, adam, pairs):
        n = int(np.asarray(adam.count))
        for p, (mu, nu) in pairs:
            if n:
                opt.state[p] = {
                    "step": torch.tensor(float(n)),
                    "exp_avg": _t(mu, device, torch.float32).reshape(p.shape),
                    "exp_avg_sq": _t(nu, device,
                                     torch.float32).reshape(p.shape)}
        sched.last_epoch = n
        for g, base, fn in zip(opt.param_groups, sched.base_lrs,
                               sched.lr_lambdas):
            g["lr"] = base * fn(n)
        sched._last_lr = [g["lr"] for g in opt.param_groups]

    adam_f = state.opt_state_fields[0]
    fields = []
    for name in port.params.towers:
        for lin, m, v in zip(getattr(port.params, name), adam_f.mu[name],
                             adam_f.nu[name]):
            fields += [(lin.weight, (np.asarray(m["kernel"]).T,
                                     np.asarray(v["kernel"]).T)),
                       (lin.bias, (m["bias"], v["bias"]))]
    fill(port.opt_fields, port.sched_fields, adam_f, fields)
    adam_p = state.opt_state_points[0]
    fill(port.opt_points, port.sched_points, adam_p,
         [(t, (adam_p.mu[k], adam_p.nu[k]))
          for k, t in port.points.trainable().items()])
    port.step = int(np.asarray(state.step))
    return port
