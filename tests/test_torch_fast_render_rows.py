"""The port's fast render path at the reference's default QueryConfig
(knn_mode / chunk_mode "xla", extract_mode "onehot" or "gather",
decode_mode "lanes") against the JAX reference's fast_render_rays_jit,
on a small sphere scene, on the CPU:

  * the candidate words the XLA route gathers (kmeta and kcand's first
    PAYW channels) equal the reference's rows layout bit for bit (compared
    as int32 bit patterns), and a converted rows cache equals the port's
    own cache;
  * the render: every counter and ray_mask exactly, colour and acc within
    the reference's bf16 bound (atol 2e-2, mean < 2e-3);
  * prob=True: ray_mask and the argmax location exactly where the two
    selections agree (a ray's max-opacity location equal within 1e-6),
    at least 90% of the hit rays agreeing; there the opacity within 2e-2
    and the neighbour averages within 3e-2, the bounds
    tests/test_grow.py::TestFastProbeParity holds the reference's own two
    prob routes to;
  * a cloud of duplicated points, whose candidate d2 tie everywhere: the
    K-selection's order decides which duplicate's attributes enter, so
    the averages hold only if the port breaks ties as lax.top_k does
    (smallest column first);
  * torch.argmax takes the first of equal maxima, as jnp.argmax does.

On the CPU no CUDA kernel launches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import fast_render as jfr
from pointnerf2studio_tpu.models import neural_points as jnpts
from pointnerf2studio_tpu.ops.grid import build_grid_from_points

torch.set_num_threads(1)

PROB = ("ray_max_shading_opacity", "ray_max_sample_loc_w",
        "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
        "shading_avg_embedding")


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


def T(a):
    return torch.as_tensor(np.array(a))


def build(cloud, cfg):
    grid = build_grid_from_points(cloud.xyz, cloud.alive, cfg.query)
    cache, rmin, svs = jfr.make_fast_scene(cfg, cloud, grid)
    return grid, cache, rmin, svs


@pytest.fixture(scope="module")
def scene():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, ray_slot_budget=16, compact_budget=16, use_cache=False))
    assert (cfg.query.knn_mode, cfg.query.chunk_mode) == ("xla", "xla")
    s = make_sphere_scene(n_points=3000, cfg=cfg)
    grid, cache, rmin, svs = build(s.cloud, cfg)
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 40, 40, 30.0))
    return s, grid, cache, rmin, svs, rays


def render_both(s, cloud, cache, rmin, svs, rays, cfg, prob):
    want = jfr.fast_render_rays_jit(
        s.params, cloud.Rw2c, cache, s.campos, s.camrotc2w, rays, s.near,
        s.far, cfg, rmin, svs, prob=prob)
    tc = port_cfg(cfg)
    _cuda.LAUNCHES.clear()
    got = tfr.fast_render_rays(
        convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                    tc.agg, device="cpu"),
        T(cloud.Rw2c), convert.fat_cache_from_jax(cache, device="cpu"),
        T(s.campos), T(s.camrotc2w), T(rays), s.near, s.far, tc, T(rmin),
        T(svs), prob=prob)
    assert sum(_cuda.LAUNCHES.values()) == 0
    return want, got


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def pack_rows(c):
    """The reference's rows layout, as int32 bit patterns, from the port's
    one cache: per candidate kmeta, then kcand's first PAYW bf16 channels
    in pairs."""
    pay = c.kcand[..., :tfr.PAYW].contiguous().view(torch.int32)
    return torch.cat([c.kmeta[..., None], pay], -1).reshape(c.max_q, -1)


def test_rows_bit_equal(scene):
    """The words the port's XLA route gathers are the reference's rows,
    bit for bit, and a converted rows cache is the port's own cache."""
    s, grid, cache, rmin, svs, rays = scene
    assert cache.kmeta is None and cache.rows.shape[0] > 1
    q = port_cfg(s.cfg).query
    got, _, _ = tfr.make_fast_scene(
        port_cfg(s.cfg), convert.cloud_from_jax(s.cloud, device="cpu"),
        convert.grid_from_jax(grid, device="cpu"),
        max_q=cache.rows.shape[0])
    assert got.cand == cache.rows.shape[1] // tfr.ROWW
    want = np.asarray(cache.rows).view(np.int32)
    np.testing.assert_array_equal(pack_rows(got).numpy(), want)
    assert not bool(bits(got.kcand[..., tfr.PAYW:]).any())
    np.testing.assert_array_equal(got.coor_2_qslot.numpy(),
                                  np.asarray(cache.coor_2_qslot))
    assert int(got.n_q) == int(cache.n_q)
    # the payload pairs hold live candidates: real metas and non-zero xyz
    meta = want.reshape(want.shape[0], -1, tfr.ROWW)[..., 0]
    assert (meta >= 0).sum() > 1000 and q.cand_cap >= got.cand
    # the converted cache carries the same bits in the same layout
    conv = convert.fat_cache_from_jax(cache, device="cpu")
    for f in ("kmeta", "kcand", "kxyz"):
        a, b = getattr(conv, f), getattr(got, f)
        assert a.shape == b.shape and a.is_contiguous(), f
        assert torch.equal(bits(a), bits(b)), f


@pytest.mark.parametrize("extract,packed", [
    ("onehot", False), ("gather", False), ("onehot", True)])
def test_xla_route_matches_jax(scene, extract, packed):
    s, grid, cache, rmin, svs, rays = scene
    q = s.cfg.query
    qkw = dict(extract_mode=extract, fast_chunk=512)
    if packed:
        qkw["depth_window"] = jfr.measured_depth_window(
            s.campos, rays, s.near, s.far, q.z_depth_dim, grid.ranges_min,
            grid.dims, q.scaled_vsize)
        qkw["ray_budget"] = int(jfr.slab_hit_mask(
            s.campos, rays, s.near, s.far, q.z_depth_dim, grid.ranges_min,
            grid.dims, q.scaled_vsize).sum()) + 8
    cfg = dataclasses.replace(s.cfg, query=dataclasses.replace(q, **qkw))
    want, got = render_both(s, s.cloud, cache, rmin, svs, rays, cfg, False)
    for f in ("dw_overflow", "rb_overflow", "cb_overflow", "n_valid_slots"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert int(g) == int(w), f
    # more slots than one chunk: several chunks of CH = 2048 run
    assert int(got.n_valid_slots) > tfr.xla_chunk_slots(
        tcfg.QueryConfig(fast_chunk=512), 10 ** 6)
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    assert 0 < mask.sum() < mask.size
    assert np.all(got.coarse_raycolor.numpy()[~mask]
                  == np.asarray(s.cfg.bg_color, np.float32))
    for g, w in ((got.coarse_raycolor, want.coarse_raycolor),
                 (got.acc, want.acc)):
        d = np.abs(g.numpy() - np.asarray(w, np.float32))
        assert d.max() <= 2e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def check_prob(want, got, min_agree=0.9):
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    assert mask.sum() > 20
    dloc = np.linalg.norm(got.ray_max_sample_loc_w.numpy()
                          - np.asarray(want.ray_max_sample_loc_w), axis=-1)
    same = mask & (dloc < 1e-6)
    assert same.sum() >= min_agree * mask.sum(), (same.sum(), mask.sum())
    dop = np.abs(got.ray_max_shading_opacity.numpy()
                 - np.asarray(want.ray_max_shading_opacity))[same]
    assert dop.max() < 2e-2
    for f in PROB[2:]:
        err = np.abs(getattr(got, f).numpy()
                     - np.asarray(getattr(want, f)))[same].max()
        assert err < 3e-2, (f, err)
    return same


@pytest.mark.parametrize("packed", [False, True])
def test_prob_matches_jax(scene, packed):
    s, grid, cache, rmin, svs, rays = scene
    q = s.cfg.query
    qkw = dict(fast_chunk=512)
    if packed:
        qkw["ray_budget"] = rays.shape[0] * 3 // 4
    cfg = dataclasses.replace(s.cfg, query=dataclasses.replace(q, **qkw))
    want, got = render_both(s, s.cloud, cache, rmin, svs, rays, cfg, True)
    if packed:
        assert int(got.rb_overflow) == int(want.rb_overflow) == 0
    same = check_prob(want, got)
    # colour of the slot-grid composite within the bf16 bound as well
    d = np.abs(got.coarse_raycolor.numpy()
               - np.asarray(want.coarse_raycolor))
    assert d.max() <= 2e-2 and d.mean() < 2e-3
    assert same.sum() > 100


def test_duplicate_points_tie_break(scene):
    """Every point twice, the copy with other attributes: all candidate d2
    tie in pairs, and the selection's tie order picks which copy's
    embedding, colour and conf the prob averages carry."""
    s, _, _, _, _, rays = scene
    c = s.cloud
    n = c.capacity
    rng = np.random.default_rng(5)
    emb2 = rng.standard_normal(np.asarray(c.points_embeding).shape)
    cloud = jnpts.from_arrays(
        np.concatenate([np.asarray(c.xyz)] * 2),
        np.concatenate([np.asarray(c.points_embeding), 0.1 * emb2]),
        np.concatenate([np.asarray(c.points_conf),
                        np.full((n, 1), 0.3, np.float32)]),
        np.concatenate([np.asarray(c.points_dir)] * 2),
        np.concatenate([np.asarray(c.points_color),
                        1 - np.asarray(c.points_color)]))
    cfg = dataclasses.replace(s.cfg, query=dataclasses.replace(
        s.cfg.query, K=3, fast_chunk=512))
    grid, cache, rmin, svs = build(cloud, cfg)
    want, got = render_both(s, cloud, cache, rmin, svs, rays, cfg, True)
    check_prob(want, got)
    want2, got2 = render_both(s, cloud, cache, rmin, svs, rays, cfg, False)
    np.testing.assert_array_equal(got2.ray_mask.numpy(),
                                  np.asarray(want2.ray_mask))
    d = np.abs(got2.coarse_raycolor.numpy()
               - np.asarray(want2.coarse_raycolor))
    assert d.max() <= 2e-2 and d.mean() < 2e-3


def test_stable_sort_breaks_ties_like_top_k():
    """The selection's order on a row of equal keys with infinities: the
    K smallest, smallest column first, the infinite ones last in column
    order: lax.top_k(-key)'s order."""
    key = np.array([[2.0, 1.0, 1.0, np.inf, 1.0, np.inf, 0.5, 2.0],
                    [np.inf] * 8], np.float32)
    want = np.asarray(jax.lax.top_k(-jnp.asarray(key), 6)[1])
    got = torch.sort(torch.as_tensor(key), dim=-1, stable=True).indices[:, :6]
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_takes_the_first_maximum():
    op = np.array([[0.1, 0.7, 0.7, 0.2], [0.0, 0.0, 0.0, 0.0],
                   [0.3, 0.1, 0.3, 0.3]], np.float32)
    np.testing.assert_array_equal(torch.argmax(torch.as_tensor(op), -1),
                                  np.asarray(jnp.argmax(jnp.asarray(op), -1)))
    assert torch.argmax(torch.as_tensor(op), -1).tolist() == [1, 0, 0]


def test_prob_needs_the_xla_route(scene):
    s, _, _, _, _, rays = scene
    cfg = port_cfg(dataclasses.replace(s.cfg, query=dataclasses.replace(
        s.cfg.query, knn_mode="fused")))
    with pytest.raises(ValueError, match="XLA route"):
        tfr.fast_render_rays(None, torch.eye(3), None, None, None,
                             torch.zeros(4, 3), 1.0, 3.0, cfg, None, None,
                             prob=True)
