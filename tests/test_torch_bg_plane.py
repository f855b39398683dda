"""The port's plane background (models/bg_plane.py) against the JAX
reference, the counterparts of tests/test_bg_plane.py, on the CPU.

Each function takes the same numpy inputs on both sides (the reference's
f32 matmuls at "highest" precision): intersections, projections, sampled
colours and the background maps within 1e-5 (float32 arithmetic in
another order), masks exactly, the foreground mask exactly. The
renderers' `bg_ray_colors`: miss rays take the given colour exactly, and
a hit ray's colour moves by (1 - acc) times the change of background
within 1e-6, through render_rays, fast_render_rays and fast_train_render;
fast_render_rays with a per-ray background against the reference's within
the bf16 bound (atol 2e-2, mean < 2e-3)."""

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
from pointnerf2studio_torch.models import bg_plane as tbg
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.models import fast_train as tft
from pointnerf2studio_torch.models import render as trender
from pointnerf2studio_tpu.config import PointNerfConfig
from pointnerf2studio_tpu.data import blender as jblender
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import bg_plane as jbg
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.models.mvsnet.layers import bilinear_grid_sample

torch.set_num_threads(1)

H = W = 16
F = 10.0
K = np.asarray([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
TOL = 1e-5


def T(a):
    return torch.as_tensor(np.array(a, np.float32))


def fan_rays(n=9, seed=0):
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)), np.ones((n, 1))], -1)
    d[0] = (1.0, 0.0, 0.0)                          # parallel to z = const
    d[1] = (0.0, 0.0, -1.0)                         # facing away
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_ray_plane_intersection_matches():
    rays = fan_rays(64)
    args = (np.float32([0.1, -0.2, 0.0]), rays, np.float32([0, 0, 3.0]),
            np.float32([0, 0.28, 0.96]))
    want_p, want_ok = jbg.ray_plane_intersection(*map(jnp.asarray, args))
    got_p, got_ok = tbg.ray_plane_intersection(*map(T, args))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok[0] and not got_ok[1] and got_ok[2:].all()
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=TOL)


def test_project_and_fg_mask_match():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (300, 2)),
                          rng.uniform(-1.0, 3.0, (300, 1))], -1).astype(
        np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = (0.05, -0.02, 0.3)
    with jax.default_matmul_precision("highest"):
        want_xy, want_in = jbg.project_points(jnp.asarray(pts), w2c, K,
                                              (H, W))
        want_m = jbg.fg_pixel_mask(jnp.asarray(pts), w2c, K, (H, W))
    got_xy, got_in = tbg.project_points(T(pts), T(w2c), T(K), (H, W))
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    assert 0 < int(got_in.sum()) < 300
    got_m = tbg.fg_pixel_mask(T(pts), T(w2c), T(K), (H, W))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert 0 < got_m.sum() < H * W


@pytest.mark.parametrize("align", [True, False])
def test_bilinear_grid_sample_edges(align):
    """Coordinates inside, on and past every edge and corner: the four
    taps with zero padding, as the reference has them."""
    img = np.random.default_rng(2).random((5, 7, 3)).astype(np.float32)
    ax = np.float32([-3.0, -1.3, -1.0, -0.999, -0.5, 0.0, 0.37, 0.999, 1.0,
                     1.2, 3.0])
    gx, gy = np.meshgrid(ax, ax[::-1])
    grid = np.stack([gx, gy], -1)
    want = bilinear_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                align_corners=align)
    got = tbg.bilinear_grid_sample(T(img), T(grid), align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert float(got.abs().min()) == 0.0           # past an edge: zero


def _views(n=2, colour=0.5, hw=H):
    images = np.full((n, hw, hw, 3), colour, np.float32)
    images[:, :2] = 0.9                             # an off-plane band
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    for v in range(n):
        poses[v, 0, 3] = 0.05 * v
    return images, poses


@pytest.mark.parametrize("with_points", [False, True])
def test_plane_background_colors_match(with_points):
    images, poses = _views(3)
    w2cs = np.linalg.inv(poses).astype(np.float32)
    intr = np.broadcast_to(K, (3, 3, 3)).copy()
    rays = fan_rays(128, seed=3)
    g = np.linspace(-0.05, 0.05, 5, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(25, np.float32)], -1)
    args = (np.float32([0, 0, 0]), rays, np.float32([0, 0, 3.0]),
            np.float32([0, 0, 1.0]), np.float32([0.5] * 3), images, w2cs,
            intr)
    with jax.default_matmul_precision("highest"):
        want_c, want_ok = jbg.plane_background_colors(
            *map(jnp.asarray, args),
            points_xyz=jnp.asarray(pts) if with_points else None)
    got_c, got_ok = tbg.plane_background_colors(
        *map(T, args), points_xyz=T(pts) if with_points else None)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert 0 < int(got_ok.sum()) < 128
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=TOL)


def _plane_dataset(mod, hw=24):
    images, poses = _views(2, hw=hw)
    f = 20.0
    intr = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32)
    return mod.BlenderDataset(images=images, poses=poses, intrinsics=intr,
                              near=1.0, far=5.0, split="train")


def test_create_all_bg_matches():
    """The maps of both packages within 1e-5, with foreground points and a
    subset of views; pixels off the plane keep the constant background."""
    kw = dict(bgmodel="plane", bg_plane_pnt=(0.0, 0.0, 3.0),
              bg_plane_normal=(0.0, 0.0, 1.0),
              bg_plane_color=(0.5, 0.5, 0.5))
    pts = np.float32([[0.0, 0.0, 1.0], [0.02, 0.01, 1.0]])
    with jax.default_matmul_precision("highest"):
        want = jbg.create_all_bg(PointNerfConfig(**kw),
                                 _plane_dataset(jblender), chunk=256,
                                 points_xyz=jnp.asarray(pts), views=[1])
    got = tbg.create_all_bg(tcfg.PointNerfConfig(**kw),
                            _plane_dataset(tblender), chunk=100,
                            points_xyz=T(pts), views=[1], device="cpu")
    assert got.shape == (2, 24, 24, 3)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert (got[0] == 1.0).all()                    # view 0 not asked for
    assert (np.abs(got[1] - 0.5) < 1e-6).any() and (got[1] == 1.0).any()


@pytest.fixture(scope="module")
def scene():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, ray_slot_budget=16, use_cache=False))
    s = make_sphere_scene(n_points=4000, cfg=cfg)
    pc = tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 16, 16, 12.0))
    bg = np.random.default_rng(5).random((rays.shape[0], 3)).astype(
        np.float32)
    return dict(
        s=s, pc=pc, rays=rays, bg=bg,
        params=convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                           pc.agg, device="cpu"),
        cloud=convert.cloud_from_jax(s.cloud, device="cpu"),
        grid=convert.grid_from_jax(s.grid, device="cpu"))


def _check_bg(out_bg, out_0, bg, bg0):
    miss = ~out_bg.ray_mask
    assert torch.equal(out_bg.ray_mask, out_0.ray_mask)
    assert 0 < int(miss.sum()) < miss.numel()
    assert torch.equal(out_bg.coarse_raycolor[miss], bg[miss])
    hit = ~miss
    moved = out_0.coarse_raycolor + (1 - out_0.acc)[:, None] * (bg - bg0)
    np.testing.assert_allclose(out_bg.coarse_raycolor[hit].detach().numpy(),
                               moved[hit].detach().numpy(), atol=1e-6)
    assert float((out_bg.coarse_raycolor - out_0.coarse_raycolor)[hit]
                 .abs().max()) > 1e-4


def test_renderers_take_bg_ray_colors(scene):
    sc, pc = scene, scene["pc"]
    s = sc["s"]
    a = (T(s.campos), T(s.camrotc2w), T(sc["rays"]), s.near, s.far, pc)
    bg, bg0 = T(sc["bg"]), T(pc.bg_color)
    with torch.no_grad():
        out_0 = trender.render_rays(sc["params"], sc["cloud"], sc["grid"], *a)
        out_bg = trender.render_rays(sc["params"], sc["cloud"], sc["grid"],
                                     *a, bg_ray_colors=bg)
    _check_bg(out_bg, out_0, bg, bg0)
    cache, rmin, svs = tfr.make_fast_scene(pc, sc["cloud"], sc["grid"])
    for rb in (0, 192):
        cfg = dataclasses.replace(pc, query=dataclasses.replace(
            pc.query, ray_budget=rb))
        f = (sc["params"], sc["cloud"].Rw2c, cache, T(s.campos),
             T(s.camrotc2w), T(sc["rays"]), s.near, s.far, cfg, rmin, svs)
        _check_bg(tfr.fast_render_rays(*f, bg_ray_colors=bg),
                  tfr.fast_render_rays(*f), bg, bg0)
    geo, grmin, gsvs = tft.make_geo_scene(pc, sc["cloud"], sc["grid"])
    for rb in (0, 192):
        cfg = dataclasses.replace(pc, query=dataclasses.replace(
            pc.query, ray_budget=rb))
        t = (sc["params"], sc["cloud"], geo, T(s.campos), T(s.camrotc2w),
             T(sc["rays"]), s.near, s.far, cfg, grmin, gsvs)
        _check_bg(tft.fast_train_render(*t, training=False,
                                        bg_ray_colors=bg),
                  tft.fast_train_render(*t, training=False), bg, bg0)


def test_fast_render_bg_matches_jax(scene):
    sc, pc = scene, scene["pc"]
    s = sc["s"]
    jcache, jrmin, jsvs = jfr.make_fast_scene(s.cfg, s.cloud, s.grid)
    want = jfr.fast_render_rays_jit(
        s.params, s.cloud.Rw2c, jcache, s.campos, s.camrotc2w,
        jnp.asarray(sc["rays"]), s.near, s.far, s.cfg, jrmin, jsvs,
        bg_ray_colors=jnp.asarray(sc["bg"]))
    cache, rmin, svs = tfr.make_fast_scene(pc, sc["cloud"], sc["grid"])
    got = tfr.fast_render_rays(
        sc["params"], sc["cloud"].Rw2c, cache, T(s.campos), T(s.camrotc2w),
        T(sc["rays"]), s.near, s.far, pc, rmin, svs,
        bg_ray_colors=T(sc["bg"]))
    np.testing.assert_array_equal(got.ray_mask.numpy(),
                                  np.asarray(want.ray_mask))
    d = np.abs(got.coarse_raycolor.numpy() - np.asarray(want.coarse_raycolor))
    assert d.max() <= 2e-2 and d.mean() < 2e-3, d.max()
