"""The legacy render's candidate cache and its K-NN in the port
(ops/grid.py::build_candidate_cache, ops/query.py::mask_raypos_qslot,
knn_from_cache, candidate_keep_mask, compact_shading_locs,
query_grid_point_index) against the JAX reference and the C++ oracle
(pointnerf2studio_tpu/native/query_ref.cpp), on the CPU.

Held exactly: the cache (coor_2_qslot, n_q, and cand_pack bit for bit:
candidate order, bit-cast point ids, shells and xyz), candidate_keep_mask,
the qslot lookup, the cache K-NN (point ids in order), the slot
compaction, and, with cand_cap >= V * P (no truncation), the cache K-NN
against the grid K-NN. The inputs are random points off exact distance
ties (the reference's compiled CPU program may contract a distance into
a fused multiply-add, the port does not). Against the oracle the
selections are compared as sets per slot, as the reference's own test
does (its scan order of equidistant candidates may differ)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.ops import grid as tgrid
from pointnerf2studio_torch.ops import query as tquery
from pointnerf2studio_tpu.config import QueryConfig
from pointnerf2studio_tpu.native import query_ref
from pointnerf2studio_tpu.ops import grid as jgrid
from pointnerf2studio_tpu.ops import query as jquery

torch.set_num_threads(1)


def small_cfg(**kw):
    """The reference's test configuration (tests/test_candidate_cache.py)."""
    base = dict(
        vsize=(0.1, 0.1, 0.1), vscale=(1, 1, 1),
        kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        ranges=(-2.0, -2.0, -2.0, 2.0, 2.0, 2.0),
        SR=8, K=4, max_o=512, P=4, z_depth_dim=32, grid_dim_pad=8,
        use_cache=True, cand_cap=512, max_q=16384)
    base.update(kw)
    return QueryConfig(**base)


def port_q(cfg):
    return tcfg.QueryConfig(**dataclasses.asdict(cfg))


def T(a):
    return torch.as_tensor(np.array(a))


def build_both(cfg, n=300, seed=3):
    xyz = np.random.default_rng(seed).uniform(
        -0.8, 0.8, size=(n, 3)).astype(np.float32)
    want = jgrid.build_grid_from_points(jnp.asarray(xyz),
                                        jnp.ones(n, bool), cfg)
    got = tgrid.build_grid_from_points(torch.from_numpy(xyz),
                                       torch.ones(n, dtype=torch.bool),
                                       port_q(cfg))
    return xyz, want, got


@pytest.fixture(scope="module")
def full():
    """No truncation: cand_cap 512 >= V * P = 108."""
    cfg = small_cfg()
    xyz, jg, tg = build_both(cfg)
    return dict(cfg=cfg, xyz=xyz, jg=jg, tg=tg)


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("over", [
    {}, dict(cand_cap=16), dict(max_q=64), dict(cand_cap=40, P=8)])
def test_cache_matches(over):
    """The port's grid and cache from the same points equal the
    reference's: the query slots (capped at max_q), n_q and every bit of
    cand_pack, with and without truncation."""
    cfg = small_cfg(**over)
    _, jg, tg = build_both(cfg, seed=5)
    assert tg.cache is not None
    np.testing.assert_array_equal(tg.coor_2_occ.numpy(),
                                  np.asarray(jg.coor_2_occ))
    np.testing.assert_array_equal(tg.cache.coor_2_qslot.numpy(),
                                  np.asarray(jg.cache.coor_2_qslot))
    assert int(tg.cache.n_q) == int(jg.cache.n_q)
    assert tg.cache.cand_pack.shape == jg.cache.cand_pack.shape
    np.testing.assert_array_equal(bits(tg.cache.cand_pack),
                                  bits(jg.cache.cand_pack))
    _, pidx, shell = tg.cache.unpack(tg.cache.cand_pack)
    assert int((pidx >= 0).sum()) > 0
    assert bool(((pidx >= 0) | (shell == 127)).all())
    if over.get("max_q") == 64:
        assert int((tg.cache.coor_2_qslot >= 0).sum()) == 64


def test_no_cache_without_use_cache():
    _, jg, tg = build_both(small_cfg(use_cache=False))
    assert jg.cache is None and tg.cache is None


def test_grid_from_jax_carries_the_cache(full):
    c = convert.grid_from_jax(full["jg"], device="cpu").cache
    np.testing.assert_array_equal(bits(c.cand_pack),
                                  bits(full["jg"].cache.cand_pack))
    assert torch.equal(c.coor_2_qslot, full["tg"].cache.coor_2_qslot)


@pytest.mark.parametrize("seed,radius2,K", [(0, 0.0, 4), (1, 0.02, 4),
                                            (2, 0.05, 2)])
def test_candidate_keep_mask_matches(seed, radius2, K):
    rng = np.random.default_rng(seed)
    B, C = 24, 40
    rel = rng.normal(0, 0.12, (B, C, 3)).astype(np.float32)
    shell = rng.integers(0, 2, (B, C)).astype(np.int32)
    valid = rng.random((B, C)) < 0.8
    half = np.full(3, 0.05, np.float32)
    want = np.asarray(jquery.candidate_keep_mask(
        jnp.asarray(rel), jnp.asarray(shell), jnp.asarray(valid),
        jnp.asarray(half), radius2, K, 1))
    got = tquery.candidate_keep_mask(T(rel), T(shell), T(valid), T(half),
                                     radius2, K, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def rays_through(n_rays=40, D=32, seed=0):
    rng = np.random.default_rng(seed)
    campos = np.array([0.0, 0.0, -2.0], np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ts = np.linspace(1.0, 3.0, D, dtype=np.float32)
    return (campos + dirs[:, None, :] * ts[None, :, None]).astype(np.float32)


@pytest.mark.parametrize("layered", [True, False])
def test_qslot_compaction_and_knn_match(full, layered):
    """The qslot lookup, the first-SR compaction with the qslots carried
    along, and the cache K-NN equal the reference's exactly."""
    cfg, jg, tg = full["cfg"], full["jg"], full["tg"]
    raypos = rays_through()
    qs_j = jquery.mask_raypos_qslot(jg, jnp.asarray(raypos))
    qs_t = tquery.mask_raypos_qslot(tg, T(raypos))
    np.testing.assert_array_equal(qs_t.numpy(), np.asarray(qs_j))
    loc_j, sm_j, qss_j = jquery.compact_shading_locs(
        jnp.asarray(raypos), qs_j >= 0, cfg.SR, extra=qs_j)
    loc_t, sm_t, qss_t = tquery.compact_shading_locs(
        T(raypos), qs_t >= 0, cfg.SR, extra=qs_t)
    np.testing.assert_array_equal(sm_t.numpy(), np.asarray(sm_j))
    np.testing.assert_array_equal(loc_t.numpy(), np.asarray(loc_j))
    np.testing.assert_array_equal(qss_t.numpy(), np.asarray(qss_j))
    R = raypos.shape[0]
    args = (cfg.K, cfg.radius_limit ** 2, (cfg.kernel_size[0] + 1) // 2)
    want = np.asarray(jquery.knn_from_cache(
        jg, qss_j.reshape(-1), loc_j.reshape(-1, 3), sm_j.reshape(-1),
        *args, layered=layered))
    got = tquery.knn_from_cache(tg, qss_t.reshape(-1),
                                loc_t.reshape(-1, 3), sm_t.reshape(-1),
                                *args, layered=layered).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any() and got.shape == (R * 8, 4)


def test_knn_from_cache_radius(full):
    """A radius limit drops candidates on both sides alike."""
    cfg, jg, tg = full["cfg"], full["jg"], full["tg"]
    locs = np.random.default_rng(9).uniform(
        -0.7, 0.7, (400, 3)).astype(np.float32)
    qs = tquery.mask_raypos_qslot(tg, T(locs)[:, None, :])[:, 0]
    mask = qs >= 0
    want = np.asarray(jquery.knn_from_cache(
        jg, jnp.asarray(qs.numpy()), jnp.asarray(locs),
        jnp.asarray(mask.numpy()), cfg.K, 0.01, 2))
    got = tquery.knn_from_cache(tg, qs, T(locs), mask, cfg.K, 0.01,
                                2).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def test_cache_knn_equals_grid_knn(full):
    """With cand_cap >= V * P the cache holds every candidate, and its
    K-NN selects the grid K-NN's point ids in the same order."""
    cfg, tg, xyz = full["cfg"], full["tg"], full["xyz"]
    locs = np.random.default_rng(4).uniform(
        -0.7, 0.7, (500, 3)).astype(np.float32)
    qs = tquery.mask_raypos_qslot(tg, T(locs)[:, None, :])[:, 0]
    mask = qs >= 0
    r2 = cfg.radius_limit ** 2
    got = tquery.knn_from_cache(tg, qs, T(locs), mask, cfg.K, r2, 2)
    want = tquery.knn_for_locs(tg, T(xyz), T(locs), mask, cfg.K, r2,
                               cfg.kernel_size, chunk=128)
    assert torch.equal(got, want)
    assert int((got >= 0).sum()) > 500


def oracle_case(n=1500, R=32, D=64, seed=3):
    """The reference's oracle case (tests/test_native_parity.py)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    alive = rng.random(n) > 0.1
    cfg = QueryConfig(
        vsize=(0.05, 0.05, 0.05), vscale=(1, 1, 1),
        kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        ranges=(-1.0,) * 3 + (1.0,) * 3, SR=12, K=4,
        max_o=20_000, P=6, grid_dim_pad=8, use_cache=True,
        cand_cap=27 * 6, max_q=80_000)
    campos = np.array([0.0, 0.0, -2.0], np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ts = np.linspace(1.0, 3.0, D, dtype=np.float32)
    raypos = (campos + dirs[:, None, :] * ts[None, :, None]).astype(
        np.float32)
    return xyz, alive, cfg, raypos


def test_cache_and_query_match_oracle():
    """The port's grid, cache route and grid route against the C++
    oracle: occupancy count, slot mask and locations exactly; the cache
    K-NN's point sets per slot exactly; query_grid_point_index (the grid
    route) exactly, and equal to the reference's."""
    xyz, alive, cfg, raypos = oracle_case()
    tg = tgrid.build_grid_from_points(T(xyz), T(alive), port_q(cfg))
    R, SR, K = raypos.shape[0], cfg.SR, cfg.K
    lo = tg.ranges_min.numpy()
    pidx_c, loc_c, smask_c, rmask_c, n_occ_c = query_ref(
        xyz, alive, lo, np.asarray(cfg.scaled_vsize, np.float32), tg.dims,
        cfg.max_o, cfg.P, cfg.query_size, cfg.kernel_size, raypos, SR, K,
        cfg.radius_limit ** 2)
    assert int(tg.n_occ) == n_occ_c
    qs = tquery.mask_raypos_qslot(tg, T(raypos))
    loc, sm, qss = tquery.compact_shading_locs(T(raypos), qs >= 0, SR,
                                               extra=qs)
    np.testing.assert_array_equal(sm.numpy(), smask_c)
    np.testing.assert_allclose(loc.numpy(), loc_c, atol=1e-6)
    pidx = tquery.knn_from_cache(
        tg, qss.reshape(-1), loc.reshape(-1, 3), sm.reshape(-1), K,
        cfg.radius_limit ** 2, 2).reshape(R, SR, K).numpy()
    np.testing.assert_array_equal(np.sort(pidx, -1), np.sort(pidx_c, -1))
    assert (pidx >= 0).sum() > R

    res = tquery.query_grid_point_index(tg, T(xyz), T(raypos), SR, K,
                                        cfg.radius_limit ** 2,
                                        cfg.kernel_size)
    np.testing.assert_array_equal(res.sample_pidx.numpy(), pidx_c)
    np.testing.assert_array_equal(res.sample_mask.numpy(), smask_c)
    np.testing.assert_array_equal(res.ray_mask.numpy(), rmask_c)
    jg = jgrid.build_grid_from_points(jnp.asarray(xyz), jnp.asarray(alive),
                                      dataclasses.replace(cfg,
                                                          use_cache=False))
    want = jquery.query_grid_point_index(
        jg, jnp.asarray(xyz), jnp.asarray(raypos), SR, K,
        cfg.radius_limit ** 2, cfg.kernel_size)
    np.testing.assert_array_equal(res.sample_pidx.numpy(),
                                  np.asarray(want.sample_pidx))
    np.testing.assert_array_equal(res.sample_loc_w.numpy(),
                                  np.asarray(want.sample_loc_w))
    np.testing.assert_array_equal(res.ray_mask.numpy(),
                                  np.asarray(want.ray_mask))
