"""The port's hash-grid caches and front-ends (models/fast_render.py
`build_fat_cache_hash` / `make_hash_fast_scene`, models/fast_train.py
`build_geo_cache_hash` / `make_hash_geo_scene`) against the port's dense
caches and the JAX reference, the counterparts of
tests/test_hash_fast_render.py, on the CPU:

  * the hash fat cache's first n_q rows equal the dense build's bit for
    bit, and the reference's hash rows cache through `convert` equals
    the port's own hash cache;
  * the hash frame equals the dense frame bit for bit, and under ray
    packing equals itself unpacked;
  * the hash geometry cache equals the dense one, and `fast_train_render`
    on it equals the dense render: forward bit for bit, gradients equal;
  * two clusters 41 units apart: the dense build raises, the hash cache
    renders the visible cluster bit-equal to a dense scene of that cluster
    alone;
  * fit_cand_cap's fence; the refusals the reference has on a hash cache
    (knn_mode="fused", chunk_mode="fused", coarse_step, the march);
  * `render_frame` on the hash cache against the reference's
    `render_frame` on its own hash scene: ray_mask and counters exactly,
    colour and acc within the bf16 bound (atol 2e-2, mean < 2e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.models import fast_train as tft
from pointnerf2studio_torch.models import neural_points as tnpts
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import grid as tgrid
from pointnerf2studio_torch.ops import hash_grid as thg
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.ops import hash_grid as jhg

torch.set_num_threads(1)

ATOL, MEAN_TOL = 2e-2, 2e-3


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def T(a):
    return torch.as_tensor(np.array(a))


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module")
def s():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, ray_slot_budget=16, use_cache=False, fast_chunk=512))
    js = make_sphere_scene(n_points=4000, cfg=cfg)
    pc = port_cfg(cfg)
    cloud = convert.cloud_from_jax(js.cloud, device="cpu")
    return dict(
        js=js, cfg=cfg, pc=pc, cloud=cloud,
        params=convert.aggregator_from_jax(
            jax.tree.map(np.asarray, js.params), pc.agg, device="cpu"),
        grid=tgrid.build_grid_from_points(cloud.xyz, cloud.alive, pc.query),
        hg=thg.build_hash_grid_from_points(cloud.xyz, cloud.alive, pc.query),
        campos=T(js.campos), camrot=T(js.camrotc2w), near=js.near,
        far=js.far)


@pytest.fixture(scope="module")
def jhash(s):
    """The reference's hash grid and hash fat cache of the scene."""
    js = s["js"]
    jh = jhg.build_hash_grid_from_points(js.cloud.xyz, js.cloud.alive,
                                         s["cfg"].query)
    return (jh,) + tuple(jfr.make_hash_fast_scene(s["cfg"], js.cloud, jh))


def render(s, cache, rmin, svs, cfg, rays, **kw):
    return tfr.fast_render_rays(s["params"], s["cloud"].Rw2c, cache,
                                s["campos"], s["camrot"], rays, s["near"],
                                s["far"], cfg, rmin, svs, **kw)


def rays_of(s, n, focal):
    return T(camera_rays(s["js"].campos, s["js"].camrotc2w, n, n, focal))


def assert_outputs_equal(a, b, fields=("coarse_raycolor", "ray_mask", "acc",
                                       "depth")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_hash_cache_matches_dense_and_reference(s, jhash):
    """The first n_q rows of the hash cache equal the dense cache's bit
    for bit; the reference's hash cache (rows layout) through
    convert.fat_cache_from_jax equals the port's hash cache there, with
    the same bucket table and logical dims."""
    pc = s["pc"]
    dcache, drmin, _ = tfr.make_fast_scene(pc, s["cloud"], s["grid"])
    hcache, hrmin, _ = tfr.make_hash_fast_scene(pc, s["cloud"], s["hg"])
    assert torch.equal(hrmin, drmin)
    assert hcache.coor_2_qslot is None and hcache.hash_table is not None
    nq = int(s["hg"].n_q)
    assert nq == int(dcache.n_q) and hcache.max_q == dcache.max_q
    for f in ("kmeta", "kcand", "kxyz"):
        assert torch.equal(bits(getattr(hcache, f)[:nq]),
                           bits(getattr(dcache, f)[:nq])), f
    jh, jcache = jhash[:2]
    conv = convert.fat_cache_from_jax(jcache, device="cpu")
    assert conv.logical_dims == hcache.logical_dims
    assert torch.equal(conv.hash_table, hcache.hash_table)
    assert torch.equal(conv.kmeta[:nq], hcache.kmeta[:nq])
    assert torch.equal(bits(conv.kcand[:nq, :, :tfr.PAYW]),
                       bits(hcache.kcand[:nq, :, :tfr.PAYW]))
    hg_conv = convert.hash_grid_from_jax(jh, device="cpu")
    assert hg_conv.dims == s["hg"].dims
    assert torch.equal(hg_conv.table, s["hg"].table)


def test_hash_frame_matches_dense(s):
    pc = s["pc"]
    rays = rays_of(s, 24, 18.0)
    dcache, drmin, dsvs = tfr.make_fast_scene(pc, s["cloud"], s["grid"])
    hcache, hrmin, hsvs = tfr.make_hash_fast_scene(pc, s["cloud"], s["hg"])
    _cuda.LAUNCHES.clear()
    ref = render(s, dcache, drmin, dsvs, pc, rays)
    out = render(s, hcache, hrmin, hsvs, pc, rays)
    assert sum(_cuda.LAUNCHES.values()) == 0
    assert int(ref.ray_mask.sum()) > 0
    assert_outputs_equal(out, ref)
    assert int(out.n_valid_slots) == int(ref.n_valid_slots)


def test_hash_ray_budget_exact(s):
    pc = s["pc"]
    rays = rays_of(s, 24, 10.0)                     # a wide field of view
    hcache, rmin, svs = tfr.make_hash_fast_scene(pc, s["cloud"], s["hg"])
    base = render(s, hcache, rmin, svs, pc, rays)
    hits = int(tfr.slab_hit_mask(s["campos"], rays, s["near"], s["far"],
                                 pc.query.z_depth_dim, rmin, s["hg"].dims,
                                 svs).sum())
    assert 0 < hits < rays.shape[0]
    cfg_rb = dataclasses.replace(pc, query=dataclasses.replace(
        pc.query, ray_budget=(hits + 15) // 16 * 16))
    out = render(s, hcache, rmin, svs, cfg_rb, rays)
    assert int(out.rb_overflow) == 0
    assert_outputs_equal(out, base)


def test_hash_geo_cache_train_matches_dense(s):
    """The hash geometry cache equals the dense one, and the train render
    through it equals the dense train render: forward bit for bit, and
    the gradients of a loss through both equal."""
    from pointnerf2studio_torch.train.loss import compute_losses
    pc = dataclasses.replace(s["pc"], train=dataclasses.replace(
        s["pc"].train, jitter=0.3))
    rays = rays_of(s, 16, 12.0)
    dgeo, drmin, dsvs = tft.make_geo_scene(pc, s["cloud"], s["grid"])
    hgeo, hrmin, hsvs = tft.make_hash_geo_scene(pc, s["cloud"], s["hg"])
    nq = int(s["hg"].n_q)
    assert hgeo.coor_2_qslot is None and hgeo.logical_dims == s["hg"].dims
    assert torch.equal(hgeo.meta[:nq], dgeo.meta[:nq])
    assert torch.equal(hgeo.rel[:nq], dgeo.rel[:nq])
    u = torch.rand((rays.shape[0], pc.query.z_depth_dim),
                   generator=torch.Generator().manual_seed(11))
    gt = T(np.random.default_rng(4).random((rays.shape[0], 3),
                                            np.float32))
    outs, grads = [], []
    for geo, rmin, svs in ((dgeo, drmin, dsvs), (hgeo, hrmin, hsvs)):
        pts = s["cloud"].with_trainable(
            {k: v.clone().requires_grad_(True)
             for k, v in s["cloud"].trainable().items()})
        o = tft.fast_train_render(s["params"], pts, geo, s["campos"],
                                  s["camrot"], rays, s["near"], s["far"], pc,
                                  rmin, svs, training=True, jitter_u=u)
        compute_losses(o, gt, pc.train)[0].backward()
        outs.append(o)
        grads.append({k: v.grad for k, v in pts.trainable().items()})
    assert int(outs[0].ray_mask.sum()) > 0
    assert_outputs_equal(outs[1], outs[0])
    for k in grads[0]:
        assert torch.equal(grads[1][k], grads[0][k]), k


def _two_clusters():
    rng = np.random.default_rng(7)
    n1 = 3000
    pts1 = rng.standard_normal((n1, 3)).astype(np.float32)
    pts1 /= np.linalg.norm(pts1, axis=-1, keepdims=True)
    pts1 *= 0.5
    colors = (pts1 + 0.5).clip(0, 1)
    dirs = pts1 / np.linalg.norm(pts1, axis=-1, keepdims=True)
    emb = rng.standard_normal((n1, 32)).astype(np.float32) * 0.1
    conf = np.full((n1, 1), 0.8, np.float32)
    one = (pts1, emb, conf, dirs, colors)
    both = tuple(np.concatenate([a, a]) for a in one)
    both[0][n1:] += np.float32(41.0)
    return one, both


def test_huge_extent_render(s):
    """Two clusters 41 units apart on the diagonal: logical dims past
    1000 an axis. The dense build refuses them; the hash cache renders
    the visible cluster bit-equal to a dense scene of that cluster alone
    (the same ranges_min, the near cluster's qslots first in (x, y, z)
    order)."""
    pc = s["pc"]
    pc = dataclasses.replace(pc, query=dataclasses.replace(
        pc.query, cand_cap=16, ranges=(-50.0,) * 3 + (50.0,) * 3))
    one, both = _two_clusters()
    cloud1 = tnpts.from_arrays(*one, device="cpu")
    cloud2 = tnpts.from_arrays(*both, device="cpu")
    grid1 = tgrid.build_grid_from_points(cloud1.xyz, cloud1.alive, pc.query)
    with pytest.raises(ValueError, match="sparse grid"):
        tgrid.build_grid_from_points(cloud2.xyz, cloud2.alive, pc.query)
    hg = thg.build_query_grid(cloud2.xyz, cloud2.alive, pc.query)
    assert isinstance(hg, thg.HashGrid)
    assert min(hg.dims) > 1000 and int(hg.overflow) == 0
    rays = rays_of(s, 24, 18.0)
    dcache, drmin, dsvs = tfr.make_fast_scene(pc, cloud1, grid1)
    hcache, hrmin, hsvs = tfr.make_hash_fast_scene(pc, cloud2, hg)
    assert torch.equal(hrmin, drmin)
    ref = render(s, dcache, drmin, dsvs, pc, rays)
    out = render(s, hcache, hrmin, hsvs, pc, rays)
    assert int(ref.ray_mask.sum()) > 0
    assert_outputs_equal(out, ref)


def test_fit_cand_cap_guard():
    assert tfr.fit_cand_cap(100_000, 64, budget_bytes=4 << 30) == 64
    cc = tfr.fit_cand_cap(3_000_000, 64, budget_bytes=int(9.6 * 2 ** 30))
    assert cc < 64 and 3_000_000 * cc * 23 * 4 <= 9.6 * 2 ** 30
    with pytest.raises(ValueError, match="infeasible"):
        tfr.fit_cand_cap(50_000_000, 64, budget_bytes=4 << 30)


REFUSED = {
    "knn_mode fused": (dict(knn_mode="fused"), "build", NotImplementedError,
                       "dense-only"),
    "coarse_step": (dict(coarse_step=2), "build", NotImplementedError,
                    "coarse_step"),
    "chunk_mode fused": (dict(chunk_mode="fused"), "render", ValueError,
                         "kernel-facing"),
    "march": (dict(march_steps=(8,), march_buckets=(64,)), "render",
              ValueError, "dense grid"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_hash_refusals(s, name):
    over, where, exc, match = REFUSED[name]
    pc = dataclasses.replace(s["pc"], query=dataclasses.replace(
        s["pc"].query, **over))
    # an aggregator the fused chunk serves, so that only the grid refuses
    pc = dataclasses.replace(pc, agg=dataclasses.replace(
        pc.agg, compute_dtype="bfloat16"))
    if where == "build":
        with pytest.raises(exc, match=match):
            tfr.make_hash_fast_scene(pc, s["cloud"], s["hg"])
        return
    cache, rmin, svs = tfr.make_hash_fast_scene(s["pc"], s["cloud"], s["hg"])
    with pytest.raises(exc, match=match):
        render(s, cache, rmin, svs, pc, rays_of(s, 8, 10.0))


def test_render_frame_matches_jax(s, jhash):
    """render_frame on the port's hash cache against the reference's
    render_frame on its own hash cache of the same scene: ray_mask and
    dw_overflow exactly, colour and acc within the bf16 bound."""
    js, cfg = s["js"], s["cfg"]
    rays = np.asarray(camera_rays(js.campos, js.camrotc2w, 20, 20, 14.0))
    kw = dict(chunk=512, tier_quant=16)
    _, jcache, jrmin, jsvs = jhash
    want = jfr.render_frame(js.params, js.cloud.Rw2c, jcache, js.campos,
                            js.camrotc2w, jnp.asarray(rays), js.near, js.far,
                            cfg, jrmin, jsvs, **kw)
    hcache, hrmin, hsvs = tfr.make_hash_fast_scene(s["pc"], s["cloud"],
                                                   s["hg"])
    got = tfr.render_frame(s["params"], s["cloud"].Rw2c, hcache, s["campos"],
                           s["camrot"], T(rays), js.near, js.far, s["pc"],
                           hrmin, hsvs, **kw)
    assert got.front_end == "depth_window"
    np.testing.assert_array_equal(got.ray_mask.numpy(),
                                  np.asarray(want.ray_mask))
    assert int(np.asarray(want.ray_mask).sum()) > 0
    for f in ("dw_overflow", "cb_overflow"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        assert a is None or int(a) == int(b) == 0, f
    for f in ("coarse_raycolor", "acc"):
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f)))
        assert d.max() <= ATOL and d.mean() < MEAN_TOL, (f, d.max())
