"""The port's slab-sharded grid query (parallel/grid_shard.py) against the
JAX reference's on the 8-device virtual CPU mesh and against the port's
unsharded query, on the CPU: the scene and rays of tests/test_grid_shard.py
(4,000 points near a sphere of radius 0.6, vsize 0.05, 64 rays of 40
samples), the slabs over 1, 2 and 3 gloo ranks spawned from the test (the
three worlds at once).

  * slab_geometry equals the reference's;
  * each rank's query equals the JAX sharded query: the neighbour ids
    exactly, the sample masks and ray masks exactly, the shading
    locations within atol 1e-6; and the unsharded query (the ids as sets
    per slot: equidistant neighbours may order differently across
    slabs).

The JAX modules are imported inside the fixture: the spawned ranks
import this module to find their function and need no JAX."""

import numpy as np
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch.ops.grid import build_grid_from_points
from pointnerf2studio_torch.ops.query import query_grid_point_index
from pointnerf2studio_torch.parallel import grid_shard as tgs
from pointnerf2studio_torch.parallel import sharding as sh

torch.set_num_threads(1)

SLABS = (1, 2, 3)
QUERY = dict(vsize=(0.05, 0.05, 0.05), vscale=(1, 1, 1), SR=12, K=4, P=8,
             max_o=8192, z_depth_dim=40, use_cache=False, grid_dim_pad=8,
             ranges=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0))


def scene():
    rng = np.random.default_rng(3)
    n = 4000
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = (0.6 * v + 0.02 * rng.normal(size=(n, 3)).astype(np.float32)
           ).astype(np.float32)
    R, D = 64, QUERY["z_depth_dim"]
    campos = np.array([0.0, 0.0, 1.8], np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.linspace(0.9, 2.9, D, dtype=np.float32)
    raypos = (campos[None, None, :] + dirs[:, None, :] * t[None, :, None]
              ).astype(np.float32)
    return xyz, raypos


def _rank(rank, path, n_slabs):
    torch.set_num_threads(1)
    cfg = tcfg.QueryConfig(**QUERY)
    xyz, raypos = scene()
    mesh = sh.make_mesh(n_slabs, device="cpu", axis_name="points")
    rmin, dims, slab_w, halo = tgs.slab_geometry(
        cfg, xyz.min(0), xyz.max(0), n_slabs)
    q = tgs.make_sharded_query(cfg, mesh, rmin, dims, slab_w, halo,
                               max_o_local=cfg.max_o)
    out = q(torch.as_tensor(xyz), torch.ones(xyz.shape[0], dtype=torch.bool),
            torch.as_tensor(raypos))
    torch.save([x.numpy() for x in out], f"{path}.{n_slabs}.{rank}")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pointnerf2studio_tpu.config import QueryConfig
    from pointnerf2studio_tpu.parallel import grid_shard as jgs

    path = str(tmp_path_factory.mktemp("grid_shard") / "query")
    worlds = {n: sh.run_ranks(_rank, n, "gloo", (path, n), join=False)
              for n in SLABS}
    cfg = QueryConfig(**QUERY)
    xyz, raypos = scene()
    want = {}
    for n in SLABS:
        geom = jgs.slab_geometry(cfg, xyz.min(0), xyz.max(0), n)
        rmin, dims, slab_w, halo = geom
        q = jgs.make_sharded_query(
            cfg, Mesh(np.asarray(jax.devices()[:n]), ("points",)), rmin,
            dims, slab_w, halo, max_o_local=cfg.max_o)
        out = q(jnp.asarray(xyz), jnp.ones((xyz.shape[0],), bool),
                jnp.asarray(raypos))
        want[n] = (geom, [np.asarray(x) for x in out])

    pc = tcfg.QueryConfig(**QUERY)
    xyz_t = torch.as_tensor(xyz)
    grid = build_grid_from_points(xyz_t, torch.ones(xyz.shape[0],
                                                    dtype=torch.bool), pc)
    r = query_grid_point_index(grid, xyz_t, torch.as_tensor(raypos), pc.SR,
                               pc.K, pc.radius_limit ** 2, pc.kernel_size,
                               layered=pc.layered_search)
    single = [x.numpy() for x in (r.sample_pidx, r.sample_loc_w,
                                  r.sample_mask, r.ray_mask)]
    got = {}
    for n, ctx in worlds.items():
        sh.wait_ranks(ctx, timeout=600)
        got[n] = [torch.load(f"{path}.{n}.{k}", weights_only=False)
                  for k in range(n)]
    return dict(want=want, got=got, single=single, xyz=xyz)


@pytest.mark.parametrize("n_slabs", SLABS)
def test_slab_geometry_matches_jax(ref, n_slabs):
    xyz = ref["xyz"]
    got = tgs.slab_geometry(tcfg.QueryConfig(**QUERY), xyz.min(0),
                            xyz.max(0), n_slabs)
    want = ref["want"][n_slabs][0]
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert tuple(got[1]) == tuple(int(x) for x in want[1])
    assert (got[2], got[3]) == (int(want[2]), int(want[3]))


@pytest.mark.parametrize("n_slabs", SLABS)
def test_sharded_query_matches_jax_and_unsharded(ref, n_slabs):
    want = ref["want"][n_slabs][1]
    one = ref["single"]
    assert (want[0] >= 0).sum() > 100
    for pidx, loc, mask, ray_mask in ref["got"][n_slabs]:
        np.testing.assert_array_equal(pidx, want[0])
        np.testing.assert_allclose(loc, want[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(mask, want[2])
        np.testing.assert_array_equal(ray_mask, want[3])
        np.testing.assert_array_equal(np.sort(pidx, -1),
                                      np.sort(one[0], -1))
        np.testing.assert_allclose(loc, one[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(mask, one[2])
        np.testing.assert_array_equal(ray_mask, one[3])


def test_slab_grid_keeps_points_in_their_global_voxels():
    """Points on every voxel face along x, and an ulp either side, where
    the voxel from a float origin shifted by x0 voxels can round apart
    from the voxel from the global origin: each slab's occupied voxels are
    the global grid's, shifted by x0."""
    cfg = tcfg.QueryConfig(**QUERY)
    lo, hi = np.full(3, -0.65, np.float32), np.full(3, 0.65, np.float32)
    rmin, dims, slab_w, halo = tgs.slab_geometry(cfg, lo, hi, 3)
    s = np.float32(cfg.scaled_vsize[0])
    faces = (rmin[0] + np.arange(dims[0] + 1, dtype=np.float32) * s
             ).astype(np.float32)
    xs = np.concatenate([np.nextafter(faces, np.float32(np.inf)), faces,
                         np.nextafter(faces, np.float32(-np.inf))])
    xs = xs[(xs > lo[0]) & (xs < hi[0])]
    xyz = torch.as_tensor(np.stack([xs, np.full_like(xs, 0.1),
                                    np.full_like(xs, -0.2)], -1))
    alive = torch.ones(xyz.shape[0], dtype=torch.bool)
    rmin_t = torch.as_tensor(rmin)
    g = torch.floor((xyz - rmin_t) / torch.tensor(cfg.scaled_vsize)).long()
    for slab in range(3):
        grid, x0 = tgs.build_slab_grid(xyz, alive, cfg, rmin_t, dims,
                                       slab_w, halo, slab, cfg.max_o)
        occ = grid.coor_2_occ >= 0
        want = torch.zeros_like(occ)
        inside = (g[:, 0] >= x0) & (g[:, 0] < x0 + occ.shape[0])
        want[g[inside, 0] - x0, g[inside, 1], g[inside, 2]] = True
        assert int(want.sum()) > 0
        assert torch.equal(occ, want), slab
