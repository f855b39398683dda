"""The reference's opt-in train routes in the port (models/fast_train.py)
on the sphere scene of tests/test_torch_fast_train.py (4,000 points, sr
16, D 48, slot budget 16, compact budget 8, float32, 16x16 rays, jitter
draws injected through `jitter_u`):

  * compact_mode="onehot" with composite_mode="grid" against the default
    topk / packed step on one batch and jitter draw: the selection
    (pnt_mask) exact, colour and acc within 1e-5, depth within 1e-4, loss
    within 1e-5 relative and every gradient within rtol 1e-3 / atol 1e-5,
    the bounds the reference's own test of that pair of modes holds
    (tests/test_fast_train.py:165-209); and the one-hot/grid forward
    against the reference's at float32 (ray_mask and pnt_mask exact,
    colour and acc within 2e-3, tests/test_torch_fast_train.py's bound);
  * TrainConfig.remat "selection" and "full": loss and every gradient
    equal to remat="none" bit for bit (tests/test_fast_train.py:303), and
    a fit() through it;
  * debug_prefix: each cut-off ("draw" under ray packing; "mid",
    "raygen", "front", "gather", "knn", "attrs", "decode") returns the
    reference's probe outputs: shapes and masks exactly, the reductions
    (coarse_raycolor) within 1e-5 relative or 1e-3 absolute: float32
    sums of up to 12,288 terms of magnitude <= 3 in another order, whose
    rounding can reach 12,288 * 3 * 2^-24 = 2.2e-3 at worst (3.8e-4
    measured), the rest within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.data import blender as tblender
from pointnerf2studio_torch.models import fast_train as tft
from pointnerf2studio_torch.train import loop as tloop
from pointnerf2studio_torch.train.loss import compute_losses as tloss
from pointnerf2studio_torch.train.trainer import create_train_state
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_train as jft

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def with_query(cfg, **kw):
    return dataclasses.replace(cfg, query=dataclasses.replace(cfg.query,
                                                              **kw))


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


@pytest.fixture(scope="module")
def s():
    cfg = with_query(sphere_config(sr=16, d=48), ray_slot_budget=16,
                     compact_budget=8)
    scene = make_sphere_scene(n_points=4000, cfg=cfg)
    geo, rmin, svs = jft.make_geo_scene(cfg, scene.cloud, scene.grid)
    rays = np.asarray(camera_rays(scene.campos, scene.camrotc2w, 16, 16,
                                  12.0))
    R, D = rays.shape[0], cfg.query.z_depth_dim
    rng = np.random.default_rng(0)
    pc = port_cfg(cfg)
    return dict(
        cfg=cfg, pc=pc, scene=scene, geo=geo, rmin=rmin, svs=svs,
        rays=rays, u=rng.random((R, D)).astype(np.float32),
        gt=rng.random((R, 3)).astype(np.float32),
        tgeo=convert.geo_cache_from_jax(geo, device="cpu"),
        cloud=convert.cloud_from_jax(scene.cloud, device="cpu"),
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, scene.params), pc.agg, device="cpu"),
        cam=(T(scene.campos), T(scene.camrotc2w)), tr=(T(rmin), T(svs)))


def render(s, cfg, state=None, **kw):
    return tft.fast_train_render(
        state.params if state else s["params"],
        state.points if state else s["cloud"], s["tgeo"], *s["cam"],
        T(s["rays"]), s["scene"].near, s["scene"].far, cfg, *s["tr"],
        jitter_u=T(s["u"]), **kw)


def step(s, cfg):
    """One forward and backward: (loss, out, [(name, gradient)])."""
    st = create_train_state(s["params"], s["cloud"], cfg)
    out = render(s, cfg, st, training=True)
    total, _ = tloss(out, T(s["gt"]), cfg.train)
    total.backward()
    grads = [(n, p.grad) for n, p in st.params.named_parameters()]
    grads += [(k, v.grad) for k, v in st.points.trainable().items()]
    return total, out, grads


def test_onehot_grid_step_matches_topk_packed(s):
    base = s["pc"]
    og = with_query(base, compact_mode="onehot", composite_mode="grid")
    l0, o0, g0 = step(s, base)
    l1, o1, g1 = step(s, og)
    assert torch.equal(o1.ray_mask, o0.ray_mask)
    assert torch.equal(o1.pnt_mask, o0.pnt_mask)
    assert 0.1 < float(o1.ray_mask.float().mean()) < 0.9
    for f, atol in (("coarse_raycolor", 1e-5), ("acc", 1e-5),
                    ("depth", 1e-4)):
        np.testing.assert_allclose(getattr(o1, f).detach().numpy(),
                                   getattr(o0, f).detach().numpy(),
                                   atol=atol, err_msg=f)
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-5)
    assert float(g1[-4][1].abs().sum()) > 0
    for (n, a), (_, b) in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=n)
    # the grid composite alone (topk compaction) takes the same sums
    og_topk = render(s, with_query(base, composite_mode="grid"),
                     training=True)
    for f in ("coarse_raycolor", "acc", "depth"):
        assert torch.equal(getattr(og_topk, f), getattr(o1, f)), f

    # against the reference's one-hot/grid forward at float32
    sc, cfg = s["scene"], with_query(s["cfg"], compact_mode="onehot",
                                     composite_mode="grid")
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p: jft.fast_train_render(
            p, sc.cloud, s["geo"], sc.campos, sc.camrotc2w,
            jnp.asarray(s["rays"]), sc.near, sc.far, cfg, s["rmin"],
            s["svs"], training=True, jitter_u=jnp.asarray(s["u"])))(
                sc.params)
    np.testing.assert_array_equal(o1.ray_mask.numpy(),
                                  np.asarray(want.ray_mask))
    np.testing.assert_array_equal(o1.pnt_mask.numpy(),
                                  np.asarray(want.pnt_mask))
    for f in ("coarse_raycolor", "acc"):
        np.testing.assert_allclose(getattr(o1, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), atol=2e-3)


@pytest.mark.parametrize("remat", ["selection", "full"])
def test_remat_gradients_bit_identical(s, remat):
    l0, o0, g0 = step(s, s["pc"])
    l1, o1, g1 = step(s, with_train(s["pc"], remat=remat))
    assert l1.item() == l0.item()
    assert torch.equal(o1.coarse_raycolor, o0.coarse_raycolor)
    for (n, a), (_, b) in zip(g1, g0):
        assert torch.equal(a, b), n


def test_fit_trains_through_the_new_routes(s, tmp_path):
    """fit() with remat, the one-hot compaction and the grid composite:
    the steps run and the loss falls."""
    sc = s["scene"]
    side = np.array([[0, 0, -1], [0, -1, 0], [-1, 0, 0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[0, :3, :3] = np.asarray(sc.camrotc2w)
    poses[0, :3, 3] = np.asarray(sc.campos)
    poses[1, :3, :3], poses[1, :3, 3] = side, (2.0, 0.0, 0.0)
    images = np.broadcast_to(np.asarray((0.8, 0.3, 0.1), np.float32),
                             (2, 16, 16, 3)).copy()
    intr = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    ds = tblender.BlenderDataset(images=images, poses=poses,
                                 intrinsics=intr, split="train",
                                 near=sc.near, far=sc.far)
    cfg = with_train(with_query(s["pc"], compact_mode="onehot",
                                composite_mode="grid"),
                     remat="selection", fast_path=True, jitter=0.0,
                     rays_per_batch=64, device_sampling=False)
    res = tloop.fit(cfg, ds, s["params"], s["cloud"], str(tmp_path),
                    max_steps=6, print_freq=1, seed=4, device="cpu")
    losses = [rec["total"] for rec in res.log]
    assert len(losses) == 6 and losses[-1] < losses[0]


PROBES = ("mid", "raygen", "front", "gather", "knn", "attrs", "decode")


@pytest.mark.parametrize("prefix", ("draw",) + PROBES)
def test_debug_prefix_probes_match(s, prefix):
    sc = s["scene"]
    cfg = s["cfg"]
    if prefix == "draw":
        cfg = with_query(cfg, ray_budget=s["rays"].shape[0])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p: jft.fast_train_render(
            p, sc.cloud, s["geo"], sc.campos, sc.camrotc2w,
            jnp.asarray(s["rays"]), sc.near, sc.far, cfg, s["rmin"],
            s["svs"], training=True, jitter_u=jnp.asarray(s["u"]),
            debug_prefix=prefix))(sc.params)
    with torch.no_grad():
        got = render(s, port_cfg(cfg), training=True, debug_prefix=prefix)
    for f in ("coarse_raycolor", "ray_mask", "acc", "depth",
              "conf_coefficient", "pnt_mask", "weight"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-5, err_msg=f,
                atol=1e-3 if f == "coarse_raycolor" else 1e-6)
    with pytest.raises(ValueError, match="debug_prefix"):
        render(s, s["pc"], debug_prefix="nothing")
