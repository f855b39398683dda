"""The port's sparse grid (ops/hash_grid.py) against the JAX reference's
and against the port's dense grid, the counterparts of
tests/test_hash_grid.py, on the CPU. Every check is exact: the HashGrid's
table, point lists, counts and coordinates equal the reference's word
for word; lookups equal the dense tables; the bucket ids equal the
reference's uint32 hash; the overflow doubling takes the reference's
sequence of bucket counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch.config import QueryConfig as TQ
from pointnerf2studio_torch.ops import grid as tgrid
from pointnerf2studio_torch.ops import hash_grid as thg
from pointnerf2studio_tpu.config import QueryConfig as JQ
from pointnerf2studio_tpu.ops import hash_grid as jhg

torch.set_num_threads(1)

FIELDS = ("table", "occ_2_pnts", "occ_numpnts", "occ_2_coor", "n_occ", "n_q",
          "overflow")


def _kw(**kw):
    base = dict(vsize=(0.05, 0.05, 0.05), vscale=(2, 2, 2), SR=16, K=8, P=4,
                max_o=4096, z_depth_dim=32, use_cache=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = (d * 0.5 + rng.normal(scale=0.01, size=(3000, 3))).astype(
        np.float32)
    alive = rng.random(3000) > 0.1
    return xyz, alive


def both(xyz, alive, bucket_slots=16, **kw):
    j = jhg.build_hash_grid_from_points(jnp.asarray(xyz), jnp.asarray(alive),
                                        JQ(**_kw(**kw)),
                                        bucket_slots=bucket_slots)
    t = thg.build_hash_grid_from_points(torch.as_tensor(xyz),
                                        torch.as_tensor(alive),
                                        TQ(**_kw(**kw)),
                                        bucket_slots=bucket_slots)
    return j, t


def assert_words_equal(j, t):
    assert tuple(int(x) for x in np.asarray(j.dims)) == t.dims
    np.testing.assert_array_equal(t.ranges_min.numpy(),
                                  np.asarray(j.ranges_min))
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("bucket_slots,max_o,P", [(8, 4096, 4),
                                                  (16, 300, 2)])
def test_matches_reference_word_for_word(cloud, bucket_slots, max_o, P):
    """Every field of the port's build equals the reference's, with max_o
    above and below the occupied count (the first max_o voxels kept)."""
    j, t = both(*cloud, bucket_slots=bucket_slots, max_o=max_o, P=P)
    assert int(t.overflow) == 0
    if max_o == 300:
        assert int(t.n_occ) > 300
    assert_words_equal(j, t)


def test_matches_dense_grid(cloud):
    """Every voxel of the dense grid looked up through the hash table:
    the dilated occupancy, the occupied slot and the qslot (the dense
    row-major numbering) equal the dense tables'; the point lists equal
    the dense grid's."""
    xyz, alive = (torch.as_tensor(a) for a in cloud)
    q = TQ(**_kw())
    dense = tgrid.build_grid_from_points(xyz, alive, q)
    hg = thg.build_hash_grid_from_points(xyz, alive, q, bucket_slots=8)
    assert int(hg.n_occ) == int(dense.n_occ)
    assert hg.dims == dense.dims
    gx, gy, gz = dense.dims
    coords = torch.stack(torch.meshgrid(
        torch.arange(gx), torch.arange(gy), torch.arange(gz),
        indexing="ij"), -1).reshape(-1, 3)
    found, occ_slot, qslot = thg.hash_lookup(hg, coords)
    dil = dense.coor_occ.reshape(-1)
    q_dense = torch.where(dil, torch.cumsum(dil.long(), 0) - 1, -1)
    assert torch.equal(found, dil)
    assert torch.equal(occ_slot, dense.coor_2_occ.reshape(-1))
    assert torch.equal(qslot.long(), q_dense)
    for f in ("occ_2_pnts", "occ_numpnts", "occ_2_coor"):
        assert torch.equal(getattr(hg, f), getattr(dense, f)), f


def test_mask_raypos_matches_dense(cloud):
    xyz, alive = (torch.as_tensor(a) for a in cloud)
    q = TQ(**_kw())
    dense = tgrid.build_grid_from_points(xyz, alive, q)
    hg = thg.build_hash_grid_from_points(xyz, alive, q)
    pos = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.9, 0.9, size=(64, 32, 3)), dtype=torch.float32)
    m_hash = thg.mask_raypos_hash(hg, pos)
    gc = torch.floor((pos - dense.ranges_min) / dense.scaled_vsize).long()
    dims = torch.tensor(dense.dims)
    inb = ((gc >= 0) & (gc < dims)).all(-1)
    gcc = torch.minimum(torch.clamp(gc, min=0), dims - 1)
    m_dense = inb & dense.coor_occ[gcc[..., 0], gcc[..., 1], gcc[..., 2]]
    assert torch.equal(m_hash, m_dense)
    assert int(m_hash.sum()) > 0


def test_huge_extent_build():
    """Logical dims near 4096 an axis (a dense int32 table would be some
    275 GB): the build equals the reference's word for word, and a numpy
    brute force of the occupied and dilated sets agrees with its counts
    and lookups."""
    rng = np.random.default_rng(2)
    n = 5000
    xyz = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    kw = dict(vsize=(0.012,) * 3, max_o=8192,
              ranges=(-60.0,) * 3 + (60.0,) * 3)
    j, hg = both(xyz, alive, **kw)
    assert min(hg.dims) > 3000
    assert not tgrid.dense_dims_feasible(hg.dims)
    assert_words_equal(j, hg)
    dims = np.asarray(hg.dims)
    vox = np.floor((xyz - hg.ranges_min.numpy())
                   / hg.scaled_vsize.numpy()).astype(np.int64)
    occ = np.unique(vox[np.all((vox >= 0) & (vox < dims), -1)], axis=0)
    assert int(hg.n_occ) == occ.shape[0]
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    dil = (occ[:, None, :] + offs[None]).reshape(-1, 3)
    dil = np.unique(dil[np.all((dil >= 0) & (dil < dims), -1)], axis=0)
    assert int(hg.n_q) == dil.shape[0]
    k = occ.shape[0]
    probes = np.clip(np.concatenate([occ, occ + [1, 0, 0], occ + [911, 0, 0]]),
                     0, dims - 1)
    found, occ_slot, qslot = thg.hash_lookup(hg, torch.as_tensor(probes))
    dil_set = set(map(tuple, dil))
    want = np.array([tuple(p) in dil_set for p in probes])
    np.testing.assert_array_equal(found.numpy(), want)
    np.testing.assert_array_equal(occ_slot[:k].numpy(), np.arange(k))
    # qslot = rank in (x, y, z) order of the dilated set
    rank = {tuple(c): i for i, c in enumerate(dil)}
    np.testing.assert_array_equal(
        qslot.numpy()[want], [rank[tuple(p)] for p in probes[want]])
    assert hg.table.numel() * 4 < 64 * 2 ** 20


def test_overflow_doubling(cloud, monkeypatch):
    """A deliberately tiny first bucket count: both builds double it
    through the same sequence of bucket counts to the same table."""
    xyz = np.random.default_rng(3).uniform(-1, 1, size=(2000, 3)).astype(
        np.float32)
    alive = np.ones(2000, bool)
    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", jhg), ("torch", thg)):
        build = mod.build_hash_grid

        def spy(*a, _b=build, _n=name, **k):
            out = _b(*a, **k)
            seen[_n].append((k.get("n_buckets", a[5] if len(a) > 5 else None),
                             int(np.asarray(out.overflow))))
            return out

        monkeypatch.setattr(mod, "suggest_buckets", lambda n, s=16: 1024)
        monkeypatch.setattr(mod, "build_hash_grid", spy)
    j = jhg.build_hash_grid_from_points(jnp.asarray(xyz), jnp.asarray(alive),
                                        JQ(**_kw()), max_attempts=8)
    t = thg.build_hash_grid_from_points(torch.as_tensor(xyz),
                                        torch.as_tensor(alive), TQ(**_kw()),
                                        max_attempts=8)
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"]) > 1 and seen["torch"][-1][1] == 0
    assert t.n_buckets > 1024
    assert_words_equal(j, t)


def test_overflow_raises_after_attempts(cloud, monkeypatch):
    monkeypatch.setattr(thg, "suggest_buckets", lambda n, s=16: 1024)
    xyz, alive = (torch.as_tensor(a) for a in cloud)
    with pytest.raises(RuntimeError, match="overflow persisted"):
        thg.build_hash_grid_from_points(xyz, alive, TQ(**_kw()),
                                        bucket_slots=1, max_attempts=1)


@pytest.mark.parametrize("lo,hi,B", [(0, 2 ** 13, 1 << 20),
                                     (-2 ** 31, 2 ** 31 - 1, 1 << 30)])
def test_mix_coords_match(lo, hi, B):
    """Bucket ids equal the reference's uint32 hash on coordinates up to
    2^13, and on every int32 (negative ones take their uint32 value)."""
    c = np.random.default_rng(5).integers(lo, hi, size=(20000, 3),
                                          dtype=np.int64).astype(np.int32)
    want = np.asarray(jhg._mix_coords(*(jnp.asarray(c[:, i]) for i in
                                        range(3)), B))
    got = thg._mix_coords(*(torch.as_tensor(c[:, i]) for i in range(3)), B)
    np.testing.assert_array_equal(got.numpy(), want)


def test_query_grid_modes(cloud):
    """grid_mode: "dense" and "auto" (at a feasible extent) give the dense
    grid, "hash" the sparse one, another name raises."""
    xyz, alive = (torch.as_tensor(a) for a in cloud)
    for mode, kind in (("dense", tgrid.PointGrid), ("auto", tgrid.PointGrid),
                       ("hash", thg.HashGrid)):
        g = thg.build_query_grid(xyz, alive, TQ(**_kw(grid_mode=mode)))
        assert isinstance(g, kind), mode
    with pytest.raises(ValueError, match="grid_mode"):
        thg.build_query_grid(xyz, alive, TQ(**_kw(grid_mode="octree")))
    assert tgrid.dense_dims_feasible((1024, 1024, 1024))
    assert not tgrid.dense_dims_feasible((1024, 1024, 1025))
