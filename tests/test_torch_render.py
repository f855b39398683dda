"""The port's legacy render (`models/render.py::render_rays`) vs the JAX
reference's `render_rays_jit` on the verify recipe's sphere (20k points
on a sphere of radius 0.5, voxel 0.02 x 2, SR 24, K 8, 120 samples per
ray, camera at (0, 0, 2), 32x32 at focal 40), without the candidate
cache, with the reference's weights, cloud and grid carried over by
convert.py.

Held exactly: the compaction (`sel`, `mask_c`, `ray_id`) against the
reference's one-hot formulation, the K-NN point ids against the
reference's `knn_for_locs`, `ray_mask` and `pnt_mask` of the whole
render, and miss rays being the background colour. Colour, acc and the
aggregation weights: with the float32 tower both sides run the same
float32 arithmetic in another summation order (atol 2e-4); with the bf16
tower and `fused_decode` on, the port's row-wise decode is held to the
reference's decode_radiance (its kernel needs a TPU backend) within the
bf16 bound of the reference's own kernel tests (atol 2e-2, mean 2e-3).
The reference runs under jax.default_matmul_precision("highest"): its
CPU default rounds matmul operands to bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.models import render as trender
from pointnerf2studio_torch.ops import _cuda
from pointnerf2studio_torch.ops import query as tquery
from pointnerf2studio_torch.ops import raygen as traygen
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models.aggregator import init_aggregator_params
from pointnerf2studio_tpu.models.render import render_rays_jit
from pointnerf2studio_tpu.ops import query as jquery
from pointnerf2studio_tpu.ops import raygen as jraygen

torch.set_num_threads(1)
H = W = 32
FOCAL = 40.0


def _T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    cfg = sphere_config()
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, use_cache=False, compact_budget=12))
    s = make_sphere_scene(n_points=20_000, cfg=cfg)
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, H, W, FOCAL))
    return dict(
        s=s, cfg=cfg, rays=rays,
        cloud=convert.cloud_from_jax(jax.tree.map(np.asarray, s.cloud),
                                     device="cpu"),
        grid=convert.grid_from_jax(s.grid, device="cpu"))


def _port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)))


def _stages(scene):
    """raypos and rp_mask on both sides, and the reference's compaction
    (render.py stage 2, its one-hot formulation) un-jitted."""
    s, q = scene["s"], scene["cfg"].query
    R, D, SR = scene["rays"].shape[0], q.z_depth_dim, q.SR
    raypos, _, _ = jraygen.near_far_linear_ray_generation(
        s.campos, jnp.asarray(scene["rays"]), D, near=s.near, far=s.far)
    rp_mask = jquery.mask_raypos(s.grid, raypos)
    rank_d = jnp.cumsum(rp_mask.astype(jnp.int32), axis=-1)
    keep = rp_mask & (rank_d <= SR)
    M = min(R * q.compact_budget, R * D)
    ohb = keep[:, :, None] & (rank_d[:, :, None] == jnp.arange(1, SR + 1))
    d_sel = jnp.einsum("rds,d->rs", ohb.astype(jnp.int32), jnp.arange(D))
    cnt = jnp.sum(keep.astype(jnp.int32), axis=-1)
    off = jnp.cumsum(cnt) - cnt
    sloti = jax.lax.broadcasted_iota(jnp.int32, (R, SR), 1)
    dest = jnp.where(sloti < cnt[:, None], off[:, None] + sloti, M)
    rayi = jax.lax.broadcasted_iota(jnp.int32, (R, SR), 0)
    sel = jnp.zeros((M,), jnp.int32).at[dest].set(rayi * D + d_sel,
                                                  mode="drop")
    mask_c = jnp.arange(M) < jnp.minimum(jnp.sum(cnt), M)
    return raypos, rp_mask, sel, mask_c, M


def test_mask_and_compaction_match(scene):
    s, q = scene["s"], scene["cfg"].query
    raypos, rp_mask, sel, mask_c, M = _stages(scene)
    t_raypos, _, _ = traygen.near_far_linear_ray_generation(
        _T(s.campos), _T(scene["rays"]), q.z_depth_dim, s.near, s.far)
    np.testing.assert_array_equal(t_raypos.numpy(), np.asarray(raypos))
    t_mask = tquery.mask_raypos(scene["grid"], t_raypos)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(rp_mask))
    _cuda.LAUNCHES.clear()
    t_sel, t_mask_c, t_ray = trender.compact_samples(
        t_mask.to(torch.int32) - 1, q.SR, M)
    assert sum(_cuda.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(t_mask_c.numpy(), np.asarray(mask_c))
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(t_ray.numpy(),
                                  np.asarray(sel) // q.z_depth_dim)
    n = int(t_mask_c.sum())
    assert 0 < n < M
    # some ray has more than SR valid samples, so the cap is exercised
    assert int(np.asarray(rp_mask).sum(-1).max()) > q.SR


@pytest.mark.parametrize("layered", [True, False])
def test_knn_matches(scene, layered):
    s, q = scene["s"], scene["cfg"].query
    raypos, _, sel, mask_c, _ = _stages(scene)
    locs = raypos.reshape(-1, 3)[sel]
    want = jquery.knn_for_locs(
        s.grid, s.cloud.xyz, locs, mask_c, q.K, q.radius_limit ** 2,
        q.kernel_size, layered=layered, chunk=4096)
    got = tquery.knn_for_locs(
        scene["grid"], scene["cloud"].xyz, _T(locs), _T(mask_c), q.K,
        q.radius_limit ** 2, q.kernel_size, layered=layered, chunk=3000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any() and (got.numpy() < 0).any()


def test_knn_ties_take_the_earlier_candidate():
    """Duplicated points give equal distances; the candidate earlier in
    scan order (the smaller point id within a voxel) must win, as
    lax.top_k's smallest-index rule does."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-0.2, 0.2, (40, 3)).astype(np.float32)
    xyz = np.concatenate([base, base])          # ids i and i + 40 coincide
    qc = dataclasses.replace(sphere_config().query, use_cache=False, P=24)
    from pointnerf2studio_tpu.ops.grid import build_grid_from_points
    jgrid = build_grid_from_points(jnp.asarray(xyz),
                                   jnp.ones(len(xyz), bool), qc)
    locs = (base[:16] + 0.003).astype(np.float32)
    mask = np.ones(16, bool)
    args = (4, qc.radius_limit ** 2, qc.kernel_size)
    want = np.asarray(jquery.knn_for_locs(
        jgrid, jnp.asarray(xyz), jnp.asarray(locs), jnp.asarray(mask),
        *args))
    got = tquery.knn_for_locs(
        convert.grid_from_jax(jgrid, device="cpu"), torch.from_numpy(xyz),
        torch.from_numpy(locs), torch.from_numpy(mask), *args).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] < 40).all() and (got[:, 1] == got[:, 0] + 40).all()


@pytest.mark.parametrize("dtype,fused,atol,mean_tol", [
    ("float32", False, 2e-4, 2e-5),
    ("bfloat16", False, 2e-2, 2e-3),
    ("bfloat16", True, 2e-2, 2e-3),
])
def test_render_rays_matches_jax(scene, dtype, fused, atol, mean_tol):
    s = scene["s"]
    cfg = dataclasses.replace(scene["cfg"], agg=dataclasses.replace(
        scene["cfg"].agg, compute_dtype=dtype, fused_decode=fused))
    with jax.default_matmul_precision("highest"):
        want = render_rays_jit(s.params, s.cloud, s.grid, s.campos,
                               s.camrotc2w, jnp.asarray(scene["rays"]),
                               s.near, s.far, cfg)
    tc = _port_cfg(cfg)
    _cuda.LAUNCHES.clear()
    got = trender.render_rays(
        convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                    tc.agg, device="cpu"),
        scene["cloud"], scene["grid"], _T(s.campos), _T(s.camrotc2w),
        _T(scene["rays"]), s.near, s.far, tc)
    assert sum(_cuda.LAUNCHES.values()) == 0

    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    frac = mask.mean()
    assert 0.3 < frac < 0.6, frac                   # the recipe's ~0.45
    np.testing.assert_array_equal(got.pnt_mask.numpy(),
                                  np.asarray(want.pnt_mask))
    color = got.coarse_raycolor.numpy()
    bg = np.asarray(cfg.bg_color, np.float32)
    assert np.all(color[~mask] == bg)
    assert np.all(color.reshape(H, W, 3)[0, 0] == bg)      # corner pixel
    assert np.any(color.reshape(H, W, 3)[H // 2, W // 2] != bg)
    # 1 / |delta| of float32 positions: the rounding of delta is relative
    # to the coordinates, not to the (small) distance
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=1e-5, rtol=1e-3)
    for g, w in ((color, want.coarse_raycolor), (got.acc.numpy(), want.acc),
                 (got.depth.numpy(), want.depth)):
        d = np.abs(g - np.asarray(w, np.float32))
        assert d.max() <= atol * max(1.0, float(np.abs(g).max())), d.max()
        assert d.mean() < mean_tol * max(1.0, float(np.abs(g).max()))
    # silhouette == ray_mask (the recipe's check)
    assert ((got.acc.numpy() > 0.2) == mask).mean() > 0.95


def test_padded_slots_leave_ray_zero_alone(scene):
    """With near = 1.49 the centre ray's sample 0 lies on the sphere
    shell. The reference scatters every padded slot's (0, false) onto
    (ray 0, sample 0), so there that ray's colour depends on whether it
    is ray 0; the port drops padded slots, and the ray renders the same
    wherever it stands in the batch."""
    s, tc = scene["s"], _port_cfg(scene["cfg"])
    agg = convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                      tc.agg, device="cpu")
    c = (H // 2) * W + W // 2
    first = np.arange(H * W)
    first[[0, c]] = [c, 0]

    def run(order):
        return trender.render_rays(
            agg, scene["cloud"], scene["grid"], _T(s.campos),
            _T(s.camrotc2w), _T(scene["rays"][order]), 1.49, s.far, tc)

    as_zero, in_place = run(first), run(np.arange(H * W))
    assert bool(as_zero.ray_mask[0]) and float(as_zero.acc[0]) > 0.3
    # sample 0 of that ray is a shading sample, and padded slots exist
    raypos, _, _ = traygen.near_far_linear_ray_generation(
        _T(s.campos), _T(scene["rays"][first]), tc.query.z_depth_dim, 1.49,
        s.far)
    assert bool(tquery.mask_raypos(scene["grid"], raypos)[0, 0])
    n_slots = int(as_zero.pnt_mask.any(-1).sum())
    assert 0 < n_slots < as_zero.pnt_mask.shape[0]
    # the reference's two colours differ by 1e-2 here; the port's agree
    # to float32 rounding (the tower's products see other row positions)
    np.testing.assert_allclose(as_zero.coarse_raycolor[0].numpy(),
                               in_place.coarse_raycolor[c].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(as_zero.acc[0].numpy(),
                               in_place.acc[c].numpy(), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(agg=dict(fused_decode=True, hidden_size=513))])
def test_unported_render_options_raise(scene, kw):
    """One step past the decode kernels' envelope (hidden 513) raises on
    the CPU as on the card; hidden 128, refused before the generic
    kernels, renders (test_render_rays_widths_match_jax)."""
    s = scene["s"]
    cfg = _port_cfg(scene["cfg"])
    cfg = dataclasses.replace(cfg, agg=dataclasses.replace(
        cfg.agg, **kw.pop("agg")))
    with pytest.raises(NotImplementedError):
        trender.render_rays(None, scene["cloud"], scene["grid"],
                            _T(s.campos), _T(s.camrotc2w), torch.zeros(4, 3),
                            s.near, s.far, cfg, **kw)


@pytest.mark.parametrize("hidden", [128, 512])
def test_render_rays_widths_match_jax(scene, hidden):
    """The legacy render with fused_decode on at hidden 128 and 512 (the
    generic decode kernel's widths; its plain version here) against the
    reference's render_rays (decode_radiance on the CPU): ray_mask and
    pnt_mask equal, colour and acc within the bf16 bound."""
    s = scene["s"]
    cfg = dataclasses.replace(scene["cfg"], agg=dataclasses.replace(
        scene["cfg"].agg, compute_dtype="bfloat16", fused_decode=True,
        hidden_size=hidden))
    params = jax.tree.map(np.asarray, init_aggregator_params(
        jax.random.PRNGKey(0), cfg.agg))
    params["density_head"][0]["bias"] = (
        params["density_head"][0]["bias"] + 5.0)
    with jax.default_matmul_precision("highest"):
        want = render_rays_jit(params, s.cloud, s.grid, s.campos,
                               s.camrotc2w, jnp.asarray(scene["rays"]),
                               s.near, s.far, cfg)
    tc = _port_cfg(cfg)
    _cuda.LAUNCHES.clear()
    got = trender.render_rays(
        convert.aggregator_from_jax(params, tc.agg, device="cpu"),
        scene["cloud"], scene["grid"], _T(s.campos), _T(s.camrotc2w),
        _T(scene["rays"]), s.near, s.far, tc)
    assert sum(_cuda.LAUNCHES.values()) == 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    np.testing.assert_array_equal(got.pnt_mask.numpy(),
                                  np.asarray(want.pnt_mask))
    for g, w in ((got.coarse_raycolor.numpy(), want.coarse_raycolor),
                 (got.acc.numpy(), want.acc)):
        d = np.abs(g - np.asarray(w, np.float32))
        assert d.max() <= 2e-2 and d.mean() < 2e-3, (d.max(), d.mean())


@pytest.fixture(scope="module")
def cached():
    """The sphere at sr 16, D 48 (tests/test_fast_train.py's scene) with
    the reference's default route: the grid's candidate cache (max_q cut
    to 32768, above the scene's query voxels)."""
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, use_cache=True, max_q=32768, compact_budget=8))
    s = make_sphere_scene(n_points=4000, cfg=cfg)
    assert s.grid.cache is not None
    assert int(s.grid.cache.n_q) < 32768
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, 16, 16, 12.0))
    rot = np.linalg.qr(np.random.default_rng(8).normal(
        size=(4000, 3, 3)))[0].astype(np.float32)
    return dict(
        s=s, cfg=cfg, rays=rays, rot=rot,
        bg=np.random.default_rng(9).random((rays.shape[0], 3)).astype(
            np.float32),
        cloud=convert.cloud_from_jax(jax.tree.map(np.asarray, s.cloud),
                                     device="cpu"),
        grid=convert.grid_from_jax(s.grid, device="cpu"))


PROB_KEYS = ("ray_max_shading_opacity", "ray_max_sample_loc_w",
             "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
             "shading_avg_embedding")


@pytest.mark.parametrize("case", [
    "use_cache", "use_cache_bf16_fused", "quadric_bf16_fused", "prob",
    "bg_ray_colors", "per_point_rw2c"])
def test_cache_route_matches_jax(cached, case):
    """render_rays on the candidate cache against the reference's
    render_rays_jit: ray_mask and pnt_mask exactly; colour, acc and depth
    within 2e-4 (mean 2e-5) at float32 and within the bf16 bound (atol
    2e-2, mean 2e-3) with the bf16 tower, each relative to max(1, the
    largest value); the prob outputs and the per-ray background at
    float32 too; with a per-point Rw2c [N, 3, 3]. The corner ray (ray 0)
    misses, so the reference's padded-slot scatter onto (ray 0, sample 0)
    changes nothing."""
    s, rays = cached["s"], cached["rays"]
    dtype = "bfloat16" if "bf16" in case else "float32"
    agg = dict(compute_dtype=dtype, fused_decode="fused" in case)
    if case.startswith("quadric"):
        agg["agg_distance_kernel"] = "quadric"
    cfg = dataclasses.replace(cached["cfg"], agg=dataclasses.replace(
        cached["cfg"].agg, **agg))
    cloud_j, cloud_t = s.cloud, cached["cloud"]
    if case == "per_point_rw2c":
        cloud_j = s.cloud.replace(Rw2c=jnp.asarray(cached["rot"]))
        cloud_t = dataclasses.replace(cloud_t, Rw2c=_T(cached["rot"]))
    kw = {}
    if case == "prob":
        kw["prob"] = True
    bg_j = bg_t = None
    if case == "bg_ray_colors":
        bg_j, bg_t = jnp.asarray(cached["bg"]), _T(cached["bg"])
    with jax.default_matmul_precision("highest"):
        want = render_rays_jit(s.params, cloud_j, s.grid, s.campos,
                               s.camrotc2w, jnp.asarray(rays), s.near,
                               s.far, cfg, bg_ray_colors=bg_j, **kw)
    tc = _port_cfg(cfg)
    _cuda.LAUNCHES.clear()
    with torch.no_grad():
        got = trender.render_rays(
            convert.aggregator_from_jax(jax.tree.map(np.asarray, s.params),
                                        tc.agg, device="cpu"),
            cloud_t, cached["grid"], _T(s.campos), _T(s.camrotc2w),
            _T(rays), s.near, s.far, tc, bg_ray_colors=bg_t, **kw)
    assert sum(_cuda.LAUNCHES.values()) == 0
    mask = got.ray_mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.ray_mask))
    np.testing.assert_array_equal(got.pnt_mask.numpy(),
                                  np.asarray(want.pnt_mask))
    assert 0.1 < mask.mean() < 0.9 and not mask[0]
    atol, mean_tol = (2e-4, 2e-5) if dtype == "float32" else (2e-2, 2e-3)
    pairs = [(got.coarse_raycolor, want.coarse_raycolor),
             (got.acc, want.acc), (got.depth, want.depth)]
    if case == "prob":
        pairs += [(getattr(got, k), getattr(want, k)) for k in PROB_KEYS]
        assert float(got.ray_max_shading_opacity.max()) > 0.1
    for g, w in pairs:
        g = g.numpy()
        d = np.abs(g - np.asarray(w, np.float32))
        scale = max(1.0, float(np.abs(g).max()))
        assert d.max() <= atol * scale, d.max()
        assert d.mean() < mean_tol * scale
    color = got.coarse_raycolor.numpy()
    bg = (cached["bg"] if case == "bg_ray_colors"
          else np.broadcast_to(np.asarray(cfg.bg_color, np.float32),
                               color.shape))
    assert np.all(color[~mask] == bg[~mask])
