"""The port's fast render path end to end vs the JAX reference's
fast_render_rays_jit under the same config (chunk_mode="fused",
select_mode="pallas", depth window and ray budget measured on the rays),
on the sphere scene of tests/test_fused_chunk.py, with the reference's
weights, cloud and cache carried over by convert.py.

Every counter and n_valid_slots must be equal, ray_mask equal, miss rays
exactly background; colour and acc within the reference's own bf16 bound
for its fused chunk (atol 2e-2, mean < 2e-3). On the CPU no CUDA kernel
launches. Importing the whole port leaves JAX out of sys.modules."""

import dataclasses
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

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
                                    tc.agg),
        T(s.cloud.Rw2c), convert.fat_cache_from_jax(cache), T(s.campos),
        T(s.camrotc2w), T(rays), s.near, s.far, tc, T(rmin), T(svs))
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


def test_unported_config_raises(scene):
    s, cache, rmin, svs, rays = scene
    cfg = _port_cfg(dataclasses.replace(s.cfg, query=dataclasses.replace(
        s.cfg.query, march_steps=(8,), march_buckets=())))
    with pytest.raises(NotImplementedError):
        tfr.fast_render_rays(None, torch.eye(3), None, None, None,
                             torch.zeros(4, 3), 1.0, 3.0, cfg, None, None)


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
