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
from pointnerf2studio_torch.ops.hash_grid import HashGrid


def _t(a, device, dtype=None) -> torch.Tensor:
    if a is None:
        return None
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


def hash_grid_from_jax(hg, device: torch.device | str | None = None
                       ) -> HashGrid:
    """A JAX HashGrid -> port HashGrid: the same table and lists, its
    logical dims as host ints."""
    device = resolve_device(device)
    i32 = torch.int32
    return HashGrid(
        ranges_min=_t(hg.ranges_min, device, torch.float32),
        scaled_vsize=_t(hg.scaled_vsize, device, torch.float32),
        dims=_host_dims(hg.dims), table=_t(hg.table, device, i32),
        occ_2_pnts=_t(hg.occ_2_pnts, device, i32),
        occ_numpnts=_t(hg.occ_numpnts, device, i32),
        occ_2_coor=_t(hg.occ_2_coor, device, i32),
        n_occ=_t(hg.n_occ, device, i32), n_q=_t(hg.n_q, device, i32),
        overflow=_t(hg.overflow, device, i32))


def _host_dims(dims):
    return None if dims is None else tuple(int(x) for x in np.asarray(dims))


def fat_cache_from_jax(cache, device: torch.device | str | None = None
                       ) -> FatCache:
    """A JAX FatCache in either layout -> port FatCache (one layout for
    every route), a dense grid's or a hash grid's (its bucket table and
    logical dims come along). The kernel-facing layout (kmeta/kpay set): the
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
                     else _t(march_table, device, torch.int32)),
        hash_table=_t(getattr(cache, "hash_table", None), device,
                      torch.int32),
        logical_dims=_host_dims(getattr(cache, "logical_dims", None)))


def geo_cache_from_jax(geo, device: torch.device | str | None = None
                       ) -> GeoCache:
    """A JAX train GeoCache (dense or hash grid) -> port GeoCache: its rows
    [max_q, C * 4] f32 split into meta (the first word of each candidate,
    an int32 bit pattern) and rel (the other three); the march table, or
    the bucket table and logical dims, where the cache has them, come
    along."""
    device = resolve_device(device)
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
                     else _t(march_table, device, torch.int32)),
        hash_table=_t(getattr(geo, "hash_table", None), device, torch.int32),
        logical_dims=_host_dims(getattr(geo, "logical_dims", None)))


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


# ---- the MVS networks: JAX trees of the reference's layout -> modules
# (regular conv [*S, I, O] -> [O, I, *S]; the transposed convs, stored by
# the reference torch-imported as [*S, O, I], -> [I, O, *S]; Linear
# [in, out] -> [out, in])

def _conv_w(w):
    nd = w.ndim - 2
    return np.transpose(w, (nd + 1, nd) + tuple(range(nd)))


def _convt_w(w):
    return np.transpose(w, (4, 3, 0, 1, 2))


def _bn_pairs(bn, p):
    for a, b in (("weight", "scale"), ("bias", "bias"),
                 ("running_mean", "mean"), ("running_var", "var")):
        yield getattr(bn, a), p[b], None


def _convbn_pairs(m, p):
    yield m.conv.weight, p["w"], _conv_w
    yield from _bn_pairs(m.bn, p["bn"])


def _fpn_pairs(net, p):
    for name in ("conv0", "conv1", "conv2"):
        for m, lp in zip(getattr(net, name), p[name]):
            yield from _convbn_pairs(m, lp)
    yield net.toplayer.weight, p["toplayer"]["w"], _conv_w
    yield net.toplayer.bias, p["toplayer"]["b"], None


def _premlp_pairs(seq, layers):
    import torch.nn as nn
    lins = [m for m in seq if isinstance(m, nn.Linear)]
    if len(lins) != len(layers):
        raise ValueError(f"premlp: {len(layers)} layers in the tree, "
                         f"{len(lins)} in the module")
    for m, lyr in zip(lins, layers):
        yield m.weight, lyr["kernel"], np.transpose
        yield m.bias, lyr["bias"], None


def _costreg_pairs(net, p):
    for i in range(7):
        yield from _convbn_pairs(getattr(net, f"conv{i}"), p[f"conv{i}"])
    for name in ("conv7", "conv9", "conv11"):
        seq = getattr(net, name)
        yield seq[0].weight, p[name]["w"], _convt_w
        yield from _bn_pairs(seq[1], p[name]["bn"])
    if "prob" in p:
        yield net.prob.weight, p["prob"]["w"], _conv_w
        yield net.prob.bias, p["prob"]["b"], None


def _mvs_pairs(m, tree):
    yield from _fpn_pairs(m.FeatureNet, tree.fpn)
    yield from _premlp_pairs(m.premlp, tree.premlp)
    yield from _costreg_pairs(m.costvol.costreg, tree.costvol["costreg"])
    yield from _convbn_pairs(m.costvol.probnet, tree.costvol["probnet"])


@torch.no_grad()
def _fill(pairs, device) -> None:
    for p, leaf, fn in pairs:
        a = np.asarray(leaf, np.float32)
        a = fn(a) if fn is not None else a
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"a leaf of shape {a.shape} does not fit a "
                             f"parameter of shape {tuple(p.shape)}")
        p.copy_(_t(a, device, torch.float32))


def fpn_from_jax(tree, device: torch.device | str | None = None):
    """A JAX FPN tree (`init_fpn_params`: conv0-2, toplayer) ->
    FeatureNet."""
    from pointnerf2studio_torch.models.mvsnet.featurenet import FeatureNet
    device = resolve_device(device)
    m = FeatureNet().to(device)
    _fill(_fpn_pairs(m, tree), device)
    return m


def mvsnet_params_from_jax(tree, device: torch.device | str | None = None):
    """The JAX depth net's tree (`load_mvsnet_params`) -> MVSNet."""
    from pointnerf2studio_torch.models.mvsnet.mvsnet import MVSNet
    device = resolve_device(device)
    m = MVSNet().to(device)
    f = tree["feature"]
    pairs = [x for i in range(7) for x in _convbn_pairs(
        getattr(m.feature, f"conv{i}"), f[f"conv{i}"])]
    pairs += [(m.feature.feature.weight, f["out"]["w"], _conv_w),
              (m.feature.feature.bias, f["out"]["b"], None)]
    pairs += list(_costreg_pairs(m.cost_regularization, tree["costreg"]))
    _fill(pairs, device)
    return m


def costvol_from_jax(tree, device: torch.device | str | None = None):
    """A JAX cost-volume tree (`init_costvol_params`: costreg, probnet)
    -> CostVolParams."""
    from pointnerf2studio_torch.models.mvsnet.costvol import CostVolParams
    device = resolve_device(device)
    m = CostVolParams(
        num_views=(tree["costreg"]["conv0"]["w"].shape[-2] - 32) // 3
    ).to(device)
    _fill(_costreg_pairs(m.costreg, tree["costreg"]), device)
    _fill(_convbn_pairs(m.probnet, tree["probnet"]), device)
    return m


def mvs_params_from_jax(mvs, device: torch.device | str | None = None):
    """A JAX `train/joint.MvsParams` (fpn, premlp, costvol) -> the port's
    MvsParams."""
    from pointnerf2studio_torch.train.joint import MvsParams
    device = resolve_device(device)
    m = MvsParams(num_views=(mvs.costvol["costreg"]["conv0"]["w"].shape[-2]
                             - 32) // 3,
                  premlp_layers=len(mvs.premlp)).to(device)
    _fill(_mvs_pairs(m, mvs), device)
    return m


@torch.no_grad()
def joint_state_from_jax(state, cfg, mvs_lr: float = 5e-4,
                         device: torch.device | str | None = None):
    """A JAX JointState -> the port's JointState of PointNerfConfig `cfg`:
    the same MVS stack and fields, each tensor's Adam moments from the
    optax states' mu and nu, the counts, the fields' schedule at its count
    and `step`."""
    from pointnerf2studio_torch.train.joint import create_joint_state
    device = resolve_device(device)
    port = create_joint_state(
        aggregator_from_jax(state.fields, cfg.agg, device=device), cfg,
        mvs_lr=mvs_lr, mvs=mvs_params_from_jax(state.mvs, device=device))

    def fill(opt, adam, pairs_mu, pairs_nu):
        n = int(np.asarray(adam.count))
        if not n:
            return
        for (p, mu, fn), (_, nu, _) in zip(pairs_mu, pairs_nu):
            conv = (lambda a: fn(np.asarray(a, np.float32))) if fn else (
                lambda a: np.asarray(a, np.float32))
            opt.state[p] = {"step": torch.tensor(float(n)),
                            "exp_avg": _t(conv(mu), device, torch.float32),
                            "exp_avg_sq": _t(conv(nu), device,
                                             torch.float32)}

    adam_m = state.opt_state_mvs[0]
    fill(port.opt_mvs, adam_m, _mvs_pairs(port.mvs, adam_m.mu),
         _mvs_pairs(port.mvs, adam_m.nu))

    adam_f = state.opt_state_fields[0]

    def field_pairs(tree):
        for name in port.fields.towers:
            for lin, lyr in zip(getattr(port.fields, name), tree[name]):
                yield lin.weight, lyr["kernel"], np.transpose
                yield lin.bias, lyr["bias"], None

    fill(port.opt_fields, adam_f, field_pairs(adam_f.mu),
         field_pairs(adam_f.nu))
    n = int(np.asarray(adam_f.count))
    port.sched_fields.last_epoch = n
    for g, base, fn in zip(port.opt_fields.param_groups,
                           port.sched_fields.base_lrs,
                           port.sched_fields.lr_lambdas):
        g["lr"] = base * fn(n)
    port.sched_fields._last_lr = [g["lr"] for g in
                                  port.opt_fields.param_groups]
    port.step = int(np.asarray(state.step))
    return port
