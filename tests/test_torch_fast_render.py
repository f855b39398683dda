"""The port's fast render path end to end vs the JAX reference's
fast_render_rays_jit under the same config (chunk_mode="fused",
select_mode="pallas", depth window and ray budget measured on the rays),
on the sphere scene of tests/test_fused_chunk.py, with the reference's
weights, cloud and cache carried over by convert.py.

Every counter and n_valid_slots must be equal, ray_mask equal, miss rays
exactly background; colour and acc within the reference's own bf16 bound
for its fused chunk (atol 2e-2, mean < 2e-3). The staged path
(knn_mode="fused", chunk_mode="xla") is held to the same reference
function: with a float32 tower and fused_decode2 off both sides run the
same float32 arithmetic in another summation order (atol 2e-4); with
the bf16 tower, and with the port's K-accumulating decode against the
reference's decode_radiance (its fused_decode2 needs a TPU backend), the
bf16 bound applies. On the CPU no CUDA kernel launches. Importing the
whole port leaves JAX out of sys.modules."""

import dataclasses
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

import pointnerf2studio_torch
from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_render as jfr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16"),
        query=dataclasses.replace(cfg.query, ray_slot_budget=16,
                                  use_cache=False, chunk_mode="fused",
                                  select_mode="pallas"))
    s = make_sphere_scene(n_points=4000, cfg=cfg)
    cache, rmin, svs = jfr.make_fast_scene(cfg, s.cloud, s.grid)
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 24, 24, 18.0))
    return s, cache, rmin, svs, rays


def _port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


@pytest.mark.parametrize("packed", [True, False, "overflow"])
def test_fast_render_matches_jax(scene, packed):
    """packed: depth window + ray budget covering the hit rays; False:
    neither; "overflow": window and ray budget too small, so dw/rb trip
    and the dropped rays and samples vanish alike in both packages. (A
    tripped cb_overflow is not compared: there the reference's packed
    composite hands rays cut off by the M budget the sums of the ray at
    slot M-1, ROADMAP §3; the port renders them as background.)"""
    s, cache, rmin, svs, rays = scene
    q = s.cfg.query
    qkw = dict(compact_budget=4)
    if packed == "overflow":
        qkw.update(depth_window=8, ray_budget=200)
    elif packed:
        qkw["depth_window"] = jfr.measured_depth_window(
            s.campos, rays, s.near, s.far, q.z_depth_dim, s.grid.ranges_min,
            s.grid.dims, q.scaled_vsize)
        hits = jfr.slab_hit_mask(s.campos, rays, s.near, s.far,
                                 q.z_depth_dim, s.grid.ranges_min,
                                 s.grid.dims, q.scaled_vsize)
        qkw["ray_budget"] = int(hits.sum()) + 16
        assert qkw["ray_budget"] < rays.shape[0]
    cfg = dataclasses.replace(s.cfg, query=dataclasses.replace(q, **qkw))
    want = jfr.fast_render_rays_jit(
        s.params, s.cloud.Rw2c, cache, s.campos, s.camrotc2w, rays,
        s.near, s.far, cfg, rmin, svs)

    T = lambda a: torch.as_tensor(np.array(a))    # noqa: E731
    tc = _port_cfg(cfg)
    _cuda.LAUNCHES.clear()
    got = tfr.fast_render_rays(
        convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                    tc.agg, device="cpu"),
        T(s.cloud.Rw2c), convert.fat_cache_from_jax(cache, device="cpu"),
        T(s.campos), T(s.camrotc2w), T(rays), s.near, s.far, tc, T(rmin),
        T(svs))
    assert sum(_cuda.LAUNCHES.values()) == 0

    for f in ("dw_overflow", "rb_overflow", "cb_overflow", "n_valid_slots"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert int(g) == int(w), f
    assert int(got.n_valid_slots) > 0
    if packed == "overflow":
        assert min(int(got.dw_overflow), int(got.rb_overflow)) > 0
    elif packed:
        assert int(got.dw_overflow) == int(got.rb_overflow) == 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    assert 0 < mask.sum() < mask.size
    color = got.coarse_raycolor.numpy()
    bg = np.asarray(s.cfg.bg_color, np.float32)
    assert np.all(color[~mask] == bg)
    for g, w in ((color, want.coarse_raycolor), (got.acc.numpy(), want.acc)):
        d = np.abs(g - np.asarray(w, np.float32))
        assert d.max() <= 2e-2 and d.mean() < 2e-3, (d.max(), d.mean())


@pytest.mark.parametrize("dtype,fused2,atol,mean_tol", [
    ("float32", False, 2e-4, 2e-5),
    ("bfloat16", False, 2e-2, 2e-3),
    ("bfloat16", True, 2e-2, 2e-3),
])
def test_staged_path_matches_jax(scene, dtype, fused2, atol, mean_tol):
    """knn_mode="fused", chunk_mode="xla": the select kernel's plain
    version, the decode tail and decode_radiance (fused2 off) or the
    K-accumulating decode (fused2 on) against the reference, whose
    select kernel runs in interpret mode on the CPU."""
    s, cache, rmin, svs, rays = scene
    q = s.cfg.query
    dw = jfr.measured_depth_window(
        s.campos, rays, s.near, s.far, q.z_depth_dim, s.grid.ranges_min,
        s.grid.dims, q.scaled_vsize)
    hits = jfr.slab_hit_mask(s.campos, rays, s.near, s.far, q.z_depth_dim,
                             s.grid.ranges_min, s.grid.dims, q.scaled_vsize)
    cfg = dataclasses.replace(
        s.cfg,
        agg=dataclasses.replace(s.cfg.agg, compute_dtype=dtype),
        query=dataclasses.replace(
            q, compact_budget=4, depth_window=dw,
            ray_budget=int(hits.sum()) + 16, knn_mode="fused",
            chunk_mode="xla"))
    with jax.default_matmul_precision("highest"):
        want = jfr.fast_render_rays_jit(
            s.params, s.cloud.Rw2c, cache, s.campos, s.camrotc2w, rays,
            s.near, s.far, cfg, rmin, svs)

    T = lambda a: torch.as_tensor(np.array(a))    # noqa: E731
    tc = _port_cfg(cfg)
    tc = dataclasses.replace(tc, agg=dataclasses.replace(
        tc.agg, fused_decode2=fused2))
    _cuda.LAUNCHES.clear()
    got = tfr.fast_render_rays(
        convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                    tc.agg, device="cpu"),
        T(s.cloud.Rw2c), convert.fat_cache_from_jax(cache, device="cpu"),
        T(s.campos), T(s.camrotc2w), T(rays), s.near, s.far, tc, T(rmin),
        T(svs))
    assert sum(_cuda.LAUNCHES.values()) == 0
    for f in ("dw_overflow", "rb_overflow", "cb_overflow", "n_valid_slots"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert int(got.dw_overflow) == int(got.rb_overflow) == 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    assert 0 < mask.sum() < mask.size
    color = got.coarse_raycolor.numpy()
    assert np.all(color[~mask] == np.asarray(s.cfg.bg_color, np.float32))
    for g, w in ((color, want.coarse_raycolor), (got.acc.numpy(), want.acc)):
        d = np.abs(g - np.asarray(w, np.float32))
        assert d.max() <= atol and d.mean() < mean_tol, (d.max(), d.mean())


def test_depth_window_helpers_match(scene):
    s, _, _, _, rays = scene
    q = s.cfg.query
    args = (s.campos, rays, s.near, s.far, q.z_depth_dim,
            s.grid.ranges_min, s.grid.dims, q.scaled_vsize)
    tspan, thit = tfr.frame_ray_spans(*args)
    jspan, jhit = jfr.frame_ray_spans(*args)
    np.testing.assert_array_equal(tspan, jspan)
    np.testing.assert_array_equal(thit, jhit)
    assert tfr.measured_depth_window(*args) == jfr.measured_depth_window(
        *args)
    np.testing.assert_array_equal(tfr.slab_hit_mask(*args, jitter=0.3),
                                  jfr.slab_hit_mask(*args, jitter=0.3))
    assert (tfr.suggest_depth_window(s.grid.dims, q.scaled_vsize, s.near,
                                     s.far, q.z_depth_dim)
            == jfr.suggest_depth_window(s.grid.dims, q.scaled_vsize, s.near,
                                        s.far, q.z_depth_dim))


# a box [-1, 1]^3 of 40^3 voxels, 64 samples over [0.5, 6]: one step 0.086
PLAN_BOX = dict(near=0.5, far=6.0, D=64, ranges_min=(-1.0, -1.0, -1.0),
                dims=(40, 40, 40), scaled_vsize=(0.05, 0.05, 0.05))
# the room preset's box (+-10 m, voxel 0.016, D 400 over [0.1, 8]), its
# bounds float32 as the grid holds them
ROOM_BOX = dict(near=0.1, far=8.0, D=400,
                ranges_min=np.full(3, -10, np.float32), dims=(1250,) * 3,
                scaled_vsize=np.full(3, 0.016, np.float32))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def plan_rays(case):
    """(campos, rays) of a frame's plan at an edge of the slab test."""
    rng = np.random.default_rng(len(case))
    step = (PLAN_BOX["far"] - PLAN_BOX["near"]) / PLAN_BOX["D"]
    if case == "outside_half":
        cp = np.array([0.2, -0.1, 3.5])
        tgt = np.c_[rng.uniform(-1.45, 1.45, (4000, 2)), np.ones(4000)]
        return cp, _unit(tgt - cp)
    if case == "inside":
        return np.array([0.1, 0.2, -0.3]), _unit(rng.normal(size=(4000, 3)))
    if case.startswith("tiny_components"):
        vals = np.array([0.0, 1e-10, -1e-10, 1e-9, -1e-9, 0.999e-9,
                         -1.001e-9, 0.3, -0.7, 1.0])
        rd = np.stack(np.meshgrid(vals, vals, vals), -1).reshape(-1, 3)
        rd = rd[np.abs(rd).max(-1) >= 0.3].astype(np.float32)
        return (np.array([0.5, 0.25, -0.4]) if case.endswith("inside")
                else np.array([0.5, 0.25, 1.6])), rd
    if case == "grazing":
        # past the edge x = 1, z = 1 by up to two steps either way
        cp = np.array([0.0, 0.0, 4.0])
        d = rng.uniform(-2 * step, 2 * step, (4000, 2))
        tgt = np.c_[1 + d[:, 0], rng.uniform(-1, 1, 4000), 1 + d[:, 1]]
        return cp, _unit(tgt - cp)
    if case == "past_far":
        # the box at 6.5-8.5 along -z: entering past far, negative spans
        cp = np.array([0.0, 0.0, 7.5])
        tgt = np.c_[rng.uniform(-1.2, 1.2, (4000, 2)), np.zeros(4000)]
        return cp, _unit(tgt - cp)
    if case == "room_frame":
        # 640x480 at focal 580 looking down past one corner of the room's
        # box: here a float32 slab test moves 55 spans by one step
        j, i = np.mgrid[0:480, 0:640]
        cam = np.stack([(i - 320) / 580, (240 - j) / 580,
                        -np.ones((480, 640))], -1).reshape(-1, 3)
        return np.array([9.5, 9.5, 12.0]), _unit(cam)
    # "ties": 20 directions, each 200 times
    cp = np.array([0.3, 0.1, 3.0])
    tgt = np.c_[rng.uniform(-1.2, 1.2, (20, 2)), np.zeros(20)]
    return cp, np.tile(_unit(tgt - cp), (200, 1))


@pytest.mark.parametrize("case", ["outside_half", "inside",
                                  "tiny_components", "tiny_components_inside",
                                  "grazing", "past_far", "ties",
                                  "room_frame"])
def test_frame_ray_order_matches_numpy(case):
    """The device plan's float64 slab test and (miss, span) sort equal
    frame_ray_spans and np.lexsort((span, ~hit)) bit for bit."""
    cp, rd = plan_rays(case)
    b = ROOM_BOX if case == "room_frame" else PLAN_BOX
    args = (b["near"], b["far"], b["D"], b["ranges_min"], b["dims"],
            b["scaled_vsize"])
    span, hit = tfr.frame_ray_spans(cp.astype(np.float32), rd, *args[:3],
                                    *args[3:])
    order, n_hit, tspan = tfr.frame_ray_order(
        torch.as_tensor(cp, dtype=torch.float32), torch.as_tensor(rd),
        *args)
    assert order.dtype == tspan.dtype == torch.int64 and n_hit.dim() == 0
    np.testing.assert_array_equal(tspan.numpy(), span)
    np.testing.assert_array_equal(order.numpy(), np.lexsort((span, ~hit)))
    assert int(n_hit) == int(hit.sum())
    if case == "outside_half":
        assert 0.3 < hit.mean() < 0.7
    if case == "past_far":
        assert (span < 0).any() and not hit.all()
    if case == "ties":
        assert len(np.unique(span[hit])) < 40 < hit.sum()


def parent_chunks(order, n_hit, span, chunk):
    """render_frame's host slicing before the plan moved to the device."""
    R = order.shape[0]
    n_chunks = -(-n_hit // chunk)
    n_used = n_chunks * chunk
    if n_used > R:
        order = np.concatenate([order, order[R - (n_used - R):]])
    ss = span[order[:n_used]]
    return order[:n_used], [int(ss[i * chunk:(i + 1) * chunk].max())
                            for i in range(n_chunks)]


@pytest.mark.parametrize("R,chunk,n_hit", [
    (1000, 128, 300),     # n_hit < R
    (1000, 128, 1000),    # every ray hits, the last chunk padded
    (1000, 128, 0),       # all background
    (1000, 300, 1000),    # padded past a chunk that does not divide R
    (100, 1024, 50)])     # a chunk past 2R: the pad is all of the order
def test_frame_chunks_one_read(R, chunk, n_hit):
    """n_hit and each chunk's largest span, read in one transfer, and the
    device-padded permutation equal the parent's slicing of
    span[order[:n_used]]."""
    rng = np.random.default_rng(R + chunk + n_hit)
    order = rng.permutation(R)
    span = rng.integers(-10**12, 400, R)
    perm, smax = tfr.frame_chunks(torch.as_tensor(order),
                                  torch.tensor(n_hit),
                                  torch.as_tensor(span), chunk)
    want_perm, want_smax = parent_chunks(order, n_hit, span, chunk)
    assert smax == want_smax and len(smax) == -(-n_hit // chunk)
    np.testing.assert_array_equal(perm.numpy(), want_perm)


def test_port_never_imports_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        pointnerf2studio_torch.__path__, "pointnerf2studio_torch.")]
    assert "pointnerf2studio_torch.models.fast_render" in mods
    code = ("import importlib, sys\n"
            "before = 'jax' in sys.modules\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(before, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False", "False"]
