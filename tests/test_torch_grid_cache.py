"""Grid and fused-layout candidate cache built by the port vs built by
the JAX reference from the same cloud: every table must be identical,
and the cache payload identical to the bit (bf16 patterns), with
cand_cap pinned on both sides. The sphere cloud is dense enough that
voxels overflow P and neighbourhoods overflow the candidate cap."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import convert
from pointnerf2studio_torch.config import QueryConfig as TQueryConfig
from pointnerf2studio_torch.models import fast_render as tfr
from pointnerf2studio_torch.ops import grid as tgrid
from pointnerf2studio_tpu.data.synthetic import make_sphere_scene, sphere_config
from pointnerf2studio_tpu.models import fast_render as jfr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    cfg = sphere_config(sr=16, d=48)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, use_cache=False))
    s = make_sphere_scene(n_points=20_000, cfg=cfg)
    tq = TQueryConfig(**dataclasses.asdict(cfg.query))
    cloud = convert.cloud_from_jax(jax.tree.map(np.asarray, s.cloud))
    return s, tq, cloud, tgrid.build_grid_from_points(cloud.xyz, cloud.alive,
                                                      tq)


def test_build_grid_matches(scene):
    s, _, _, g = scene
    assert g.dims == tuple(s.grid.dims)
    np.testing.assert_array_equal(g.ranges_min.numpy(),
                                  np.asarray(s.grid.ranges_min))
    for f in ("coor_2_occ", "coor_occ", "occ_2_pnts", "occ_numpnts",
              "n_occ", "occ_2_coor"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(s.grid, f)), f)
    # the cloud overflows P in some voxels: truncation is exercised
    assert int(g.occ_numpnts.max()) > g.occ_2_pnts.shape[1]


@pytest.mark.parametrize("cand_cap", [16, 64])
def test_fused_cache_matches(scene, cand_cap):
    s, tq, cloud, g = scene
    max_q = 32768
    want = jfr.build_fat_cache(s.grid, s.cloud, tq.kernel_size, max_q,
                               cand_cap, layout="fused")
    got = tfr.build_fat_cache(g, cloud, tq.kernel_size, max_q, cand_cap)
    assert got.cand == want.kmeta.shape[1] == cand_cap
    assert int(got.n_q) == int(want.n_q)
    np.testing.assert_array_equal(got.coor_2_qslot.numpy(),
                                  np.asarray(want.coor_2_qslot))
    np.testing.assert_array_equal(got.kmeta.numpy(), np.asarray(want.kmeta))
    np.testing.assert_array_equal(
        got.kpay.view(torch.int16).numpy(),
        np.asarray(want.kpay).view(np.int16))
    # converting the JAX cache gives the same tensors
    conv = convert.fat_cache_from_jax(want)
    assert torch.equal(conv.kmeta, got.kmeta)
    assert torch.equal(conv.kpay.view(torch.int16), got.kpay.view(torch.int16))


def test_fit_cand_cap():
    assert tfr.fit_cand_cap(1000, 64) == jfr.fit_cand_cap(1000, 64)
    budget = 589_824 * 16 * tfr.ROWW * 4
    assert tfr.fit_cand_cap(589_824, 64, budget_bytes=budget) == 16
    with pytest.raises(ValueError):
        tfr.fit_cand_cap(589_824, 64, budget_bytes=1000)
