"""The port's raster front-end (ops/raster.py) against the JAX reference
and against the port's own march, at the size of tests/test_raster.py
(chair with 30,000 points, vsize 0.016, 64x64 at focal 220, D = 64, SR 24,
BP 16).

`camera_rays_device` within 1e-6 of the reference's and of the port's
numpy `camera_rays`; `build_qvox`, the voxel footprints, the emit table
and the counters equal to the reference's on the same ray array; the emit
table equal to the port's march on every ray (lanes below the count): the
counters alone do not prove it, since the band check drops a sample
without moving any of them. Each counter trips when its budget is cut,
and the packing guards raise, a frame of exactly 2^22 pixels included
(its last key would be the dead-row sentinel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch.data.synthetic import camera_rays
from pointnerf2studio_torch.ops import march as tm
from pointnerf2studio_torch.ops import raster as tr
from pointnerf2studio_tpu.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig)
from pointnerf2studio_tpu.data.synthetic import make_chair_scene
from pointnerf2studio_tpu.ops import raster as jr

torch.set_num_threads(1)

H = W = 64
FOCAL = 220.0
D = 64
CAP = 16
CLASSES = ((2, 2, 2), (3, 3, 2), (5, 5, 3))
BUDGETS = (0, 16384, 4096)
PINHOLE = (210.0, 222.0, 30.0, 34.5)
# The band phase places each sample with ray directions recomputed inline.
# Under jit the reference contracts those products and sums into fused
# multiply-adds and takes a hardware rsqrt; the port rounds every step. A
# sample within an ulp of the band's edge can therefore be accepted by one
# and not by the other (one such row of some 30,000 at this size). The
# exact verify drops it on both sides, so the emit tables stay equal; only
# counters that count band-phase rows (live_overflow, certain_flip) may
# differ, by at most this many rows.
BAND_EDGE_ROWS = 2


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg = PointNerfConfig(
        query=QueryConfig(
            vsize=(0.016,) * 3, vscale=(2, 2, 2), SR=24, K=8, P=12,
            max_o=200_000, z_depth_dim=D, compact_budget=4,
            ray_slot_budget=CAP, use_cache=False, fast_chunk=512),
        agg=AggregatorConfig(compute_dtype="bfloat16"))
    scene = make_chair_scene(n_points=30_000, cfg=cfg)
    occ = np.asarray(scene.grid.coor_occ).astype(bool)
    n_q = int(occ.sum())
    max_q = (n_q + 1023) // 1024 * 1024
    c2q = np.where(occ.reshape(-1), np.cumsum(occ.reshape(-1)) - 1,
                   -1).astype(np.int32).reshape(occ.shape)
    geo = dict(rmin=np.asarray(scene.grid.ranges_min),
               svs=np.asarray(cfg.query.scaled_vsize, np.float32),
               campos=np.asarray(scene.campos),
               rot=np.asarray(scene.camrotc2w),
               near=np.float32(scene.near), far=np.float32(scene.far))
    geo["step"] = (geo["far"] - geo["near"]) / np.float32(D)
    rays = np.asarray(jr.camera_rays_device(scene.camrotc2w, H, W, FOCAL))
    return dict(c2q=c2q, max_q=max_q, geo=geo, rays=rays, march={})


def _port_emit(s, rays, focal=FOCAL, classes=CLASSES, budgets=BUDGETS,
               live_budget=1 << 20):
    g = s["geo"]
    qvox = tr.build_qvox(T(s["c2q"]), s["max_q"])
    prog = tr.make_raster_program(H, W, focal, D, CAP, classes=classes,
                                  class_budgets=budgets,
                                  live_budget=live_budget)
    emit, ctr = prog(qvox, T(g["rmin"]), T(g["svs"]), T(g["campos"]),
                     T(g["rot"]), T(rays), T(g["near"]), T(g["step"]))
    return emit.numpy(), ctr.numpy()


def _jax_emit(s, rays, focal=FOCAL, classes=CLASSES, budgets=BUDGETS,
              live_budget=1 << 20):
    g = s["geo"]
    qvox = jr.build_qvox(jnp.asarray(s["c2q"]), s["max_q"])
    prog = jr.make_raster_program(H, W, focal, D, CAP, classes=classes,
                                  class_budgets=budgets,
                                  live_budget=live_budget)
    emit, ctr = prog(qvox, g["rmin"], g["svs"], g["campos"], g["rot"],
                     jnp.asarray(rays), jnp.asarray(g["near"]),
                     jnp.asarray(g["step"]), jnp.float32(0.0))
    return np.asarray(emit), np.asarray(ctr)


def _port_march(s, rays):
    """(emit, cnt) of the port's walk with fuel to spare; the frame's own
    rays are walked once for all tests."""
    if rays is s["rays"] and s["march"]:
        return s["march"]["frame"]
    g = s["geo"]
    table = tm.build_march_table(T(s["c2q"]))
    dims = table.shape
    emit, cnt, of = tm.march_rays(
        table.reshape(-1), T(np.array(dims, np.int32)), dims[1], dims[2],
        T(g["rmin"]), T(g["svs"]), T(g["campos"]), T(rays), T(g["near"]),
        T(g["far"]), T(g["step"]), D, CAP, (2 * D + 8,), ())
    assert int(of) == 0
    if rays is s["rays"]:
        s["march"]["frame"] = (emit.numpy(), cnt.numpy())
    return emit.numpy(), cnt.numpy()


@pytest.mark.parametrize("focal", [FOCAL, PINHOLE])
def test_camera_rays_device(setup, focal):
    rot = setup["geo"]["rot"]
    got = tr.camera_rays_device(T(rot), H, W, focal).numpy()
    want = np.asarray(jr.camera_rays_device(jnp.asarray(rot), H, W, focal))
    assert got.shape == (H * W, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    if focal == FOCAL:
        own = camera_rays(T(rot), H, W, FOCAL).numpy()
        assert np.abs(got - own).max() <= 1e-6
    assert tr._intrin4(focal, H, W) == jr._intrin4(focal, H, W)


def test_build_qvox_matches_jax(setup):
    s = setup
    got = tr.build_qvox(T(s["c2q"]), s["max_q"]).numpy()
    want = np.asarray(jr.build_qvox(jnp.asarray(s["c2q"]), s["max_q"]))
    np.testing.assert_array_equal(got, want)
    n_q = int((s["c2q"] >= 0).sum())
    assert (got[:n_q] >= 0).all() and (got[n_q:] == -1).all()
    with pytest.raises(ValueError, match="1024"):
        tr.build_qvox(torch.zeros((2, 1025, 2), dtype=torch.int32), 8)


@pytest.mark.parametrize("focal", [FOCAL, PINHOLE])
def test_voxel_footprint_matches_jax(setup, focal):
    s, g = setup, setup["geo"]
    qv = tr.build_qvox(T(s["c2q"]), s["max_q"])
    got = tr._voxel_footprint(
        qv, T(g["rmin"]), T(g["svs"]), T(g["campos"]), T(g["rot"]), H, W,
        focal, T(g["near"]), T(g["far"]), D, T(g["step"]))
    want = jax.jit(lambda q: jr._voxel_footprint(
        q, g["rmin"], g["svs"], g["campos"], g["rot"], H, W, focal,
        jnp.asarray(g["near"]), jnp.asarray(g["far"]), D,
        jnp.asarray(g["step"])))(jnp.asarray(qv.numpy()))
    ok = np.asarray(want[6])
    np.testing.assert_array_equal(got[6].numpy(), ok)
    assert 0 < ok.sum() < ok.size
    for name, a, b in zip("i0 j0 d0 w h nd".split(), got, want):
        np.testing.assert_array_equal(a.numpy()[ok], np.asarray(b)[ok],
                                      err_msg=name)


def test_emit_matches_march_and_jax(setup):
    s = setup
    emit, ctr = _port_emit(s, s["rays"])
    assert emit.shape == (H * W, CAP) and emit.dtype == np.int32
    np.testing.assert_array_equal(ctr, [0, 0, 0, 0])
    m_emit, m_cnt = _port_march(s, s["rays"])
    np.testing.assert_array_equal((emit != 0).sum(-1), m_cnt)
    lanes = np.arange(CAP)[None, :] < m_cnt[:, None]
    np.testing.assert_array_equal(emit[lanes], m_emit[lanes])
    assert (emit[~lanes] == 0).all()
    assert m_cnt.max() == CAP and (m_cnt == 0).any()
    j_emit, j_ctr = _jax_emit(s, s["rays"])
    np.testing.assert_array_equal(j_ctr, [0, 0, 0, 0])
    np.testing.assert_array_equal(emit, j_emit)


def test_emit_with_loader_style_rays(setup):
    """Off-centre intrinsics and rays normalised with a +1e-5 norm guard,
    as a dataset loader makes them: the band absorbs the ~1e-5 direction
    shift and the exact verify uses the caller's rays."""
    s = setup
    fx, fy, cx, cy = PINHOLE
    i, j = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([(i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy,
                  np.ones_like(i, np.float64)], -1).reshape(-1, 3)
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-5)
    rays = (d @ s["geo"]["rot"].T.astype(np.float64)).astype(np.float32)
    emit, ctr = _port_emit(s, rays, focal=PINHOLE)
    np.testing.assert_array_equal(ctr, [0, 0, 0, 0])
    m_emit, m_cnt = _port_march(s, rays)
    np.testing.assert_array_equal((emit != 0).sum(-1), m_cnt)
    lanes = np.arange(CAP)[None, :] < m_cnt[:, None]
    np.testing.assert_array_equal(emit[lanes], m_emit[lanes])
    j_emit, j_ctr = _jax_emit(s, rays, focal=PINHOLE)
    np.testing.assert_array_equal(j_ctr, [0, 0, 0, 0])
    np.testing.assert_array_equal(emit, j_emit)


@pytest.mark.parametrize("name,kw", [
    ("class_overflow", dict(classes=((2, 2, 2), (3, 3, 3)),
                            budgets=(0, 16384))),
    ("list_overflow", dict(budgets=(0, 64, 4096))),
    ("live_overflow", dict(live_budget=4096)),
])
def test_counters_trip(setup, name, kw):
    """A budget cut below what the frame needs moves its counter, by the
    reference's count, and the table no longer equals the march's."""
    s = setup
    emit, ctr = _port_emit(s, s["rays"], **kw)
    j_emit, j_ctr = _jax_emit(s, s["rays"], **kw)
    names = ["class_overflow", "list_overflow", "live_overflow",
             "certain_flip"]
    assert np.abs(ctr - j_ctr).max() <= BAND_EDGE_ROWS
    assert ctr[names.index(name)] > 0
    assert all(c == 0 for n, c in zip(names, ctr) if n != name)
    np.testing.assert_array_equal(emit, j_emit)
    assert ((emit != 0).sum(-1) != _port_march(s, s["rays"])[1]).any()


def test_certain_flip_counts_a_wrong_ray_array(setup):
    """Rays that disagree with the pixel formula by far more than the
    band (the frame flipped left to right): rows the band phase was
    certain of fail the exact verify, and the counter says so."""
    s = setup
    flipped = s["rays"].reshape(H, W, 3)[:, ::-1].reshape(-1, 3).copy()
    _, ctr = _port_emit(s, flipped)
    _, j_ctr = _jax_emit(s, flipped)
    assert ctr[3] > 0 and ctr[:3].sum() == 0
    assert np.abs(ctr - j_ctr).max() <= BAND_EDGE_ROWS


def test_guards_raise(setup):
    s, g = setup, setup["geo"]
    qv = tr.build_qvox(T(s["c2q"]), s["max_q"])
    args = (T(g["rmin"]), T(g["svs"]), T(g["campos"]), T(g["rot"]))

    def emit(qvox, rays, h, w, d=D):
        return tr.raster_emit_table(qvox, *args, rays, h, w, FOCAL,
                                    T(g["near"]), None, d, T(g["step"]), CAP)

    with pytest.raises(ValueError, match="z_depth_dim <= 512"):
        emit(qv, T(s["rays"]), H, W, d=513)
    # exactly 2^22 pixels: the reference lets this frame through, and its
    # last pixel's deepest key equals the dead-row sentinel
    assert ((1 << 22) - 1) << 9 | 511 == tr.INT_MAX
    with pytest.raises(ValueError, match="2\\^22 pixels"):
        emit(qv, torch.zeros((1 << 22, 3)), 2048, 2048)
    with pytest.raises(ValueError, match="max_q"):
        emit(torch.zeros(((1 << 22) - 1, 3), dtype=torch.int32),
             T(s["rays"]), H, W)
    with pytest.raises(ValueError, match="frame"):
        emit(qv, T(s["rays"][:-1]), H, W)
    for exc in (tr.RasterUnserved("x"),):
        assert isinstance(exc, ValueError)
