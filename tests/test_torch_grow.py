"""Point growing and the structure changes of the port against the JAX
reference, on the CPU, on the sphere scene of tests/test_grow.py:

  * `_dilate1`, `prune`, `grow` (with candidates past the free count and
    `new_valid` false), `expand_capacity` (a per-point Rw2c too),
    `reset_point_opt_slots` and `expand_state_capacity` on the same state
    (carried by `convert.train_state_from_jax`): bit for bit; one Adam
    update of the expanded states with the same gradients within rtol
    1e-5 / atol 1e-8 (float32 Adam arithmetic in another order, the bound
    of tests/test_torch_train_loop.py);
  * `probe_view` through both probes against the reference's on a cloud
    with a hole cut clean through it: the same pixels grow (all of them
    through the legacy probe, at least 95% of either side's picks through
    the fast one) and the candidates' location within one
    voxel, conf within 3e-2 (the reference's fast-against-legacy probe
    bounds, tests/test_grow.py:191-203);
  * the reference's hole recipe (tests/test_grow.py:119-165) through the
    port's `probe_and_grow`, and the port's growth picking the same slots
    as the reference's (exactly through the legacy probe, float32 on both
    sides; within 5% of the count through the fast probe, whose bf16
    geometry may flip a pixel at the threshold)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.data import blender as tblender
from pointnerf2studio_torch.models import neural_points as tnpts
from pointnerf2studio_torch.ops import grid as tgrid_mod
from pointnerf2studio_torch.train import grow as tgrow
from pointnerf2studio_torch.train import trainer as ttrainer
from pointnerf2studio_tpu.data import blender as jblender
from pointnerf2studio_tpu.data.synthetic import (
    camera_rays, make_sphere_scene, sphere_config)
from pointnerf2studio_tpu.models import neural_points as jnpts
from pointnerf2studio_tpu.ops.grid import build_grid_from_points
from pointnerf2studio_tpu.train import grow as jgrow
from pointnerf2studio_tpu.train import trainer as jtrainer
from pointnerf2studio_tpu.train.evaluator import (
    make_render_chunk_fn, render_image)

torch.set_num_threads(1)

H = W = 24
FOCAL = 16.0


def port_cfg(cfg):
    return tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(cfg.train)))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def cloud_equal(got, want):
    for f in ("xyz", "points_embeding", "points_conf", "points_dir",
              "points_color", "Rw2c", "alive"):
        np.testing.assert_array_equal(getattr(got, f).detach().numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.fixture(scope="module")
def scene():
    s = make_sphere_scene(n_points=2000, cfg=sphere_config(sr=8, d=32))
    xyz = np.asarray(s.cloud.xyz)
    # a hole clean through the sphere along the view axis
    hole = np.linalg.norm(xyz[:, :2], axis=-1) < 0.28
    cloud = s.cloud.replace(alive=jnp.asarray(~hole))
    grid = build_grid_from_points(cloud.xyz, cloud.alive, s.cfg.query)
    rays = np.asarray(camera_rays(s.campos, s.camrotc2w, H, W, FOCAL))
    full = render_image(make_render_chunk_fn(s.cfg), s.params, s.cloud,
                        s.grid, np.asarray(s.campos),
                        np.asarray(s.camrotc2w), rays, (H, W), s.near,
                        s.far, chunk=192)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(s.camrotc2w)
    pose[:3, 3] = np.asarray(s.campos)
    arrays = dict(images=full["coarse_raycolor"][None].astype(np.float32),
                  poses=pose[None],
                  intrinsics=np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2],
                                       [0, 0, 1]], np.float32),
                  near=s.near, far=s.far, split="train")
    pc = port_cfg(s.cfg)
    return dict(
        s=s, hole=hole, cloud=cloud, grid=grid, pc=pc,
        jds=jblender.BlenderDataset(**arrays),
        tds=tblender.BlenderDataset(**arrays),
        tcloud=convert.cloud_from_jax(cloud, device="cpu"),
        tgrid=convert.grid_from_jax(grid, device="cpu"),
        tparams=convert.aggregator_from_jax(np_tree(s.params), pc.agg,
                                            device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dilate1_matches(seed):
    m = np.random.default_rng(seed).random((9, 13)) < 0.15
    np.testing.assert_array_equal(
        tgrow._dilate1(torch.as_tensor(m)).numpy(), jgrow._dilate1(m))


def test_prune_matches(scene):
    conf = np.random.default_rng(3).random((2000, 1)).astype(np.float32)
    cloud = scene["cloud"].replace(points_conf=jnp.asarray(conf))
    got = tnpts.prune(convert.cloud_from_jax(cloud, device="cpu"), 0.4)
    cloud_equal(got, jnpts.prune(cloud, 0.4))
    assert 0 < int(got.num_alive) < int(np.asarray(cloud.num_alive))


def _candidates(m, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(m, c)).astype(np.float32)
            for c in (3, 32, 1, 3, 3)]


@pytest.mark.parametrize("m,valid_every", [(40, 1), (700, 1), (300, 3)])
def test_grow_matches(scene, m, valid_every):
    """m = 40 fits the free slots; 700 exceeds them (the rest drop); every
    third candidate invalid leaves holes in the placement."""
    cloud = scene["cloud"]
    free = int(np.asarray(~cloud.alive).sum())
    assert 40 < free < 700
    cand = _candidates(m, m)
    valid = np.arange(m) % valid_every == 0
    want = jnpts.grow(cloud, *map(jnp.asarray, cand), jnp.asarray(valid))
    got = tnpts.grow(scene["tcloud"], *map(torch.as_tensor, cand),
                     torch.as_tensor(valid))
    cloud_equal(got, want)
    assert int(got.num_alive) == int(np.asarray(cloud.num_alive)) + min(
        int(valid[:free].sum()), free)


@pytest.mark.parametrize("per_point", [False, True])
def test_expand_capacity_matches(scene, per_point):
    cloud = scene["cloud"]
    if per_point:
        rot = np.tile(np.eye(3, dtype=np.float32), (cloud.capacity, 1, 1))
        rot[::7] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        cloud = cloud.replace(Rw2c=jnp.asarray(rot))
    got = tnpts.expand_capacity(convert.cloud_from_jax(cloud, device="cpu"),
                                3000)
    cloud_equal(got, jnpts.expand_capacity(cloud, 3000))
    assert got.capacity == 3000
    with pytest.raises(ValueError, match="shrink"):
        tnpts.expand_capacity(got, 10)


def _trained_state(scene):
    """A JAX train state whose Adam moments and counts are not zero: three
    updates taken by the optimizers on random gradients."""
    s = scene["s"]
    st = jtrainer.create_train_state(s.params, scene["cloud"], s.cfg)
    tx_f, tx_p = jtrainer.make_optimizers(s.cfg)
    rng = np.random.default_rng(7)
    o_f, o_p = st.opt_state_fields, st.opt_state_points
    pts = st.points.trainable()
    for _ in range(3):
        g_f = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), st.params)
        g_p = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), pts)
        _, o_f = tx_f.update(g_f, o_f, st.params)
        _, o_p = tx_p.update(g_p, o_p, pts)
    return st.replace(opt_state_fields=o_f, opt_state_points=o_p,
                      step=jnp.asarray(3, jnp.int32))


def moments_equal(port, jax_state):
    adam = jax_state.opt_state_points[0]
    for k, p in port.points.trainable().items():
        st = port.opt_points.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(adam.mu[k]), err_msg=k)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(adam.nu[k]), err_msg=k)
        assert float(st["step"]) == int(adam.count)


def test_train_state_from_jax(scene):
    st = _trained_state(scene)
    port = convert.train_state_from_jax(np_tree(st), scene["pc"],
                                        device="cpu")
    assert port.step == 3
    moments_equal(port, st)
    adam_f = st.opt_state_fields[0]
    w = port.params.mlp_base[0].weight
    np.testing.assert_array_equal(
        port.opt_fields.state[w]["exp_avg"].numpy(),
        np.asarray(adam_f.mu["mlp_base"][0]["kernel"]).T)
    # the schedulers sit at the optax count
    assert port.sched_points.last_epoch == 3
    span = scene["pc"].train.lr_decay_iters
    assert port.opt_points.param_groups[0]["lr"] == pytest.approx(
        scene["pc"].train.lr_points * 0.1 ** (3 / span), rel=1e-12)


def test_reset_point_opt_slots_matches(scene):
    st = _trained_state(scene)
    port = convert.train_state_from_jax(np_tree(st), scene["pc"],
                                        device="cpu")
    slots = np.array([0, 5, 17, 1999])
    opt_p = jgrow.reset_point_opt_slots(st.opt_state_points, slots)
    ttrainer.reset_point_opt_slots(port.opt_points, torch.as_tensor(slots))
    moments_equal(port, st.replace(opt_state_points=opt_p))
    e = port.opt_points.state[port.points.points_embeding]["exp_avg"]
    assert torch.all(e[slots] == 0) and torch.all(e[1] != 0)


def test_expand_state_capacity_matches(scene):
    """Expansion, then one Adam update of the points with the same
    gradients on both sides."""
    st = _trained_state(scene)
    port = convert.train_state_from_jax(np_tree(st), scene["pc"],
                                        device="cpu")
    sched_pos = port.sched_points.last_epoch
    want = jgrow.expand_state_capacity(st, 2500)
    ttrainer.expand_state_capacity(port, 2500)
    cloud_equal(port.points, want.points)
    moments_equal(port, want)
    assert port.sched_points.last_epoch == sched_pos
    params = port.opt_points.param_groups[0]["params"]
    assert [p is t for p, t in zip(
        params, port.points.trainable().values())] == [True] * 4
    rng = np.random.default_rng(11)
    pts = want.points.trainable()
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in pts.items()}
    _, tx_p = jtrainer.make_optimizers(scene["s"].cfg)
    upd, _ = tx_p.update(jax.tree.map(jnp.asarray, grads),
                         want.opt_state_points, pts)
    new = jax.tree.map(lambda a, b: a + b, pts, upd)
    for k, t in port.points.trainable().items():
        t.grad = torch.as_tensor(grads[k])
    port.opt_points.step()
    for k, t in port.points.trainable().items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(new[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def probes(scene):
    """The reference's and the port's probe of the hole view, both
    routes, at the threshold of tests/test_grow.py."""
    s = scene["s"]
    fs = jgrow.make_probe_scene(s.cfg, s.params, scene["cloud"],
                                scene["grid"], near=s.near, far=s.far)
    want = {"fast": jgrow.probe_view(
                s.cfg, s.params, scene["cloud"], scene["grid"],
                scene["jds"], 0, chunk=192, opacity_thresh=0.05,
                fast_scene=fs),
            "legacy": jgrow.probe_view(
                s.cfg, s.params, scene["cloud"], scene["grid"],
                scene["jds"], 0, chunk=192, opacity_thresh=0.05)}
    tfs = tgrow.make_probe_scene(scene["pc"], scene["tcloud"],
                                 scene["tgrid"])
    got = {name: tgrow.probe_view(
        scene["pc"], scene["tparams"], scene["tcloud"], scene["tgrid"],
        scene["tds"], 0, chunk=192, opacity_thresh=0.05,
        fast_scene=tfs if name == "fast" else None)
        for name in ("fast", "legacy")}
    return want, got


def match(a, b, tol):
    """For each row of a [n, 3], whether a row of b lies within `tol`."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(len(a), bool)
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    return d.min(1) < tol


@pytest.mark.parametrize("route", ["fast", "legacy"])
def test_probe_view_matches_jax(scene, probes, route):
    want, got = probes
    w = {k: np.asarray(v) for k, v in want[route].items()}
    g = {k: v.numpy() for k, v in got[route].items()}
    assert w["xyz"].shape[0] >= 5
    assert set(g) == set(w)
    vs = max(scene["s"].cfg.query.scaled_vsize)
    # the legacy probe is float32 on both sides: the same pixels grow; the
    # fast probe's geometry is bf16, and a pixel at the threshold may flip
    share = 1.0 if route == "legacy" else 0.95
    assert match(g["xyz"], w["xyz"], 1e-5).mean() >= share
    assert match(w["xyz"], g["xyz"], 1e-5).mean() >= share
    assert match(g["xyz"], w["xyz"], vs).all()
    if g["xyz"].shape == w["xyz"].shape:
        same = np.linalg.norm(g["xyz"] - w["xyz"], axis=-1) < 1e-5
        for k in ("embedding", "color", "dir", "conf"):
            assert np.abs(g[k] - w[k])[same].max() < 3e-2, k


def test_fast_probe_near_legacy(probes):
    """The port's two probes pick nearly the same pixels."""
    _, got = probes
    a, b = got["fast"]["xyz"].numpy(), got["legacy"]["xyz"].numpy()
    assert match(a, b, 0.04).mean() >= 0.9 and match(b, a, 0.04).mean() >= 0.9


@pytest.mark.parametrize("route", ["fast", "legacy"])
def test_hole_grows_back(scene, route):
    """tests/test_grow.py::test_probe_and_grow_fills_holes in the port."""
    pc = scene["pc"]
    state = ttrainer.create_train_state(scene["tparams"], scene["tcloud"], pc)
    before = int(state.points.num_alive)
    times = {}
    state, grid, n_new = tgrow.probe_and_grow(
        pc, state, scene["tgrid"], scene["tds"], views=[0], chunk=192,
        opacity_thresh=0.05, probe=route, timings=times)
    assert n_new > 0
    assert int(state.points.num_alive) == before + n_new
    assert set(times) == {"probe_s", "grow_s", "rebuild_s"}
    grown = (state.points.alive.numpy() & scene["hole"])
    r_xy = np.linalg.norm(state.points.xyz.numpy()[grown][:, :2], axis=-1)
    assert grown.sum() == n_new and r_xy.mean() < 0.4
    # the grid is rebuilt on the grown cloud and holds the grown points
    # (its origin follows the live points' box, so its voxel count need
    # not rise)
    fresh = tgrid_mod.build_grid_from_points(
        state.points.xyz, state.points.alive, pc.query)
    assert torch.equal(grid.coor_2_occ, fresh.coor_2_occ)
    vox = torch.floor((state.points.xyz[torch.as_tensor(grown)]
                       - grid.ranges_min) / grid.scaled_vsize).long()
    assert torch.all(grid.coor_2_occ[vox[:, 0], vox[:, 1], vox[:, 2]] >= 0)


@pytest.mark.parametrize("route", ["fast", "legacy"])
def test_probe_and_grow_matches_jax(scene, route, monkeypatch):
    """The same slots grow in both packages (the grid and the Adam moments
    of the grown slots follow). The legacy probe is float32 on both sides:
    the same count, the same slots, the same places to 1e-5. The fast
    probe's geometry is bf16: the counts within 5%, and the common slots
    within a voxel."""
    s, pc = scene["s"], scene["pc"]
    st = _trained_state(scene)
    if route == "legacy":
        monkeypatch.setenv("PN2S_LEGACY_PROBE", "1")
    want, wgrid, wn = jgrow.probe_and_grow(
        s.cfg, st, scene["grid"], scene["jds"], views=[0], chunk=192,
        opacity_thresh=0.05)
    port = convert.train_state_from_jax(np_tree(st), pc, device="cpu")
    port, tgrid, tn = tgrow.probe_and_grow(
        pc, port, scene["tgrid"], scene["tds"], views=[0], chunk=192,
        opacity_thresh=0.05, probe=route)
    wa, ta = np.asarray(want.points.alive), port.points.alive.numpy()
    new_w, new_t = wa & ~np.asarray(st.points.alive), ta & ~np.asarray(
        st.points.alive)
    if route == "legacy":
        assert tn == wn > 0
        np.testing.assert_array_equal(new_t, new_w)
        tol = 1e-5
    else:
        assert tn > 0 and abs(tn - wn) <= max(1, wn // 20)
        # the grown slots are the first dead ones in both: one set holds
        # the other
        assert (new_w & new_t).sum() == min(wn, tn)
        tol = max(s.cfg.query.scaled_vsize)
    both = new_w & new_t
    d = np.linalg.norm(port.points.xyz.numpy()[both]
                       - np.asarray(want.points.xyz)[both], axis=-1)
    assert (d < tol).all()
    e = port.opt_points.state[port.points.points_embeding]["exp_avg"]
    assert torch.all(e[torch.as_tensor(new_t)] == 0)


def test_pad_grow_count_matches():
    for m in (0, 1, 255, 256, 257, 1000):
        assert tgrow.pad_grow_count(m) == jgrow.pad_grow_count(m)


def test_probe_rejects_unknown_route(scene):
    with pytest.raises(ValueError, match="probe must be"):
        tgrow.probe_and_grow(scene["pc"], None, None, scene["tds"],
                             probe="auto")
