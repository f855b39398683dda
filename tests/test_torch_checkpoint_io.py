"""Checkpoints of the port (utils/checkpoint_io.py) against the JAX
reference's, on the CPU:

  * the `.pth` export of the same weights and cloud (dead slots, and a
    per-point Rw2c) equals the reference's: the same keys, the same
    arrays bit for bit;
  * the port imports a `.pth` the reference wrote, and the reference
    imports the port's: weights and live points bit for bit;
  * the `<step>_states.pth` sidecar both ways;
  * the native checkpoint: save, restore and one more update equal one
    more update of the original bit for bit (weights, Adam moments, step
    counts, learning rates, `step`), also after a capacity expansion;
    `latest_step` and a re-save of the same step."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from pointnerf2studio_torch import config as tcfg
from pointnerf2studio_torch import convert
from pointnerf2studio_torch.train import trainer as ttrainer
from pointnerf2studio_torch.utils import checkpoint_io as tcio
from pointnerf2studio_tpu.data.synthetic import make_sphere_scene, sphere_config
from pointnerf2studio_tpu.utils import checkpoint_io as jcio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    s = make_sphere_scene(n_points=600, cfg=sphere_config(sr=8, d=24))
    alive = np.ones(600, bool)
    alive[::5] = False
    cloud = s.cloud.replace(alive=alive)
    cfg = tcfg.PointNerfConfig(
        query=tcfg.QueryConfig(**dataclasses.asdict(s.cfg.query)),
        agg=tcfg.AggregatorConfig(**dataclasses.asdict(s.cfg.agg)),
        train=tcfg.TrainConfig(**dataclasses.asdict(s.cfg.train)))
    params = jax.tree.map(np.asarray, s.params)
    return dict(s=s, cloud=cloud, cfg=cfg, params=params,
                tparams=convert.aggregator_from_jax(params, cfg.agg,
                                                    device="cpu"))


def per_point(cloud):
    rot = np.tile(np.eye(3, dtype=np.float32), (cloud.capacity, 1, 1))
    rot[::3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    rot[1::3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    return cloud.replace(Rw2c=rot)


@pytest.mark.parametrize("rw2c", ["global", "per point"])
def test_export_matches_jax(scene, tmp_path, rw2c):
    cloud = scene["cloud"] if rw2c == "global" else per_point(scene["cloud"])
    jcio.export_torch_checkpoint(scene["params"], cloud,
                                 str(tmp_path / "j.pth"))
    tcio.export_torch_checkpoint(
        scene["tparams"], convert.cloud_from_jax(cloud, device="cpu"),
        str(tmp_path / "t.pth"))
    want = torch.load(tmp_path / "j.pth", weights_only=True)
    got = torch.load(tmp_path / "t.pth", weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    assert got["neural_points.points_conf"].shape == (1, 480, 1)


def _cloud_equal_live(got, want_cloud):
    alive = np.asarray(want_cloud.alive)
    for f in ("xyz", "points_embeding", "points_conf", "points_dir",
              "points_color"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[:alive.sum()],
            np.asarray(getattr(want_cloud, f))[alive], err_msg=f)


@pytest.mark.parametrize("rw2c", ["global", "per point"])
def test_port_reads_jax_pth(scene, tmp_path, rw2c):
    cloud = scene["cloud"] if rw2c == "global" else per_point(scene["cloud"])
    path = str(tmp_path / "j.pth")
    jcio.export_torch_checkpoint(scene["params"], cloud, path)
    params, pts = tcio.load_reference_checkpoint(path, scene["cfg"].agg,
                                                 capacity=700, device="cpu")
    for name in params.towers:
        for a, b in zip(getattr(params, name),
                        getattr(scene["tparams"], name)):
            assert torch.equal(a.weight, b.weight) and torch.equal(
                a.bias, b.bias), name
    assert pts.capacity == 700 and int(pts.num_alive) == 480
    _cloud_equal_live(pts, cloud)
    jp, jpts = jcio.load_reference_checkpoint(path, capacity=700)
    np.testing.assert_array_equal(pts.Rw2c.numpy(), np.asarray(jpts.Rw2c))


@pytest.mark.parametrize("rw2c", ["global", "per point"])
def test_jax_reads_port_pth(scene, tmp_path, rw2c):
    cloud = scene["cloud"] if rw2c == "global" else per_point(scene["cloud"])
    path = str(tmp_path / "t.pth")
    tcio.export_torch_checkpoint(
        scene["tparams"], convert.cloud_from_jax(cloud, device="cpu"), path)
    params, pts = jcio.load_reference_checkpoint(path)
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(scene["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    alive = np.asarray(cloud.alive)
    np.testing.assert_array_equal(np.asarray(pts.points_embeding),
                                  np.asarray(cloud.points_embeding)[alive])
    want_rot = np.asarray(cloud.Rw2c)
    np.testing.assert_array_equal(
        np.asarray(pts.Rw2c), want_rot[alive] if want_rot.ndim == 3
        else want_rot)


def test_import_rejects_a_missing_tower(scene, tmp_path):
    path = str(tmp_path / "t.pth")
    tcio.export_torch_checkpoint(scene["tparams"], None, path)
    sd = tcio.load_torch_state_dict(path)
    del sd["aggregator.block3.0.weight"], sd["aggregator.block3.0.bias"]
    with pytest.raises(ValueError, match="block3"):
        tcio.import_aggregator_params(sd, scene["cfg"].agg, device="cpu")


def test_states_file_both_ways(tmp_path):
    tcio.export_states_file(str(tmp_path / "t.pth"), 2, 300, 27.5, 250)
    jcio.export_states_file(str(tmp_path / "j.pth"), 2, 300, 27.5, 250)
    want = {"epoch_count": 2, "total_steps": 300, "best_PSNR": 27.5,
            "best_iter": 250}
    for name in ("t.pth", "j.pth"):
        assert tcio.load_states_file(str(tmp_path / name)) == want
        assert jcio.load_states_file(str(tmp_path / name)) == want


def _update(state, cfg, seed):
    """One optimizer update (both groups) from seeded random gradients."""
    g = torch.Generator().manual_seed(seed)
    state.zero_grad()
    for p in list(state.params.parameters()) + list(
            state.points.trainable().values()):
        p.grad = torch.randn(p.shape, generator=g)
    ttrainer.apply_updates(state, cfg)


def _states_equal(a, b):
    assert a.step == b.step
    for f in ("xyz", "Rw2c", "alive"):
        assert torch.equal(getattr(a.points, f), getattr(b.points, f)), f
    for x, y in zip(list(a.params.parameters())
                    + list(a.points.trainable().values()),
                    list(b.params.parameters())
                    + list(b.points.trainable().values())):
        assert torch.equal(x, y)
    for oa, ob in ((a.opt_fields, b.opt_fields), (a.opt_points, b.opt_points)):
        assert [g["lr"] for g in oa.param_groups] == [
            g["lr"] for g in ob.param_groups]
        for pa, pb in zip(oa.param_groups[0]["params"],
                          ob.param_groups[0]["params"]):
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(oa.state[pa][k], ob.state[pb][k]), k


@pytest.mark.parametrize("expand", [False, True])
def test_native_restore_then_step(scene, tmp_path, expand):
    cfg = dataclasses.replace(scene["cfg"], train=dataclasses.replace(
        scene["cfg"].train, lr_decay_iters=10))
    cloud = convert.cloud_from_jax(scene["cloud"], device="cpu")
    a = ttrainer.create_train_state(scene["tparams"], cloud, cfg)
    for i in range(2):
        _update(a, cfg, i)
    if expand:
        ttrainer.expand_state_capacity(a, 1024)
    ckpt = str(tmp_path / "ckpt")
    tcio.save_train_state(ckpt, a, 2)
    template = ttrainer.create_train_state(scene["tparams"], cloud, cfg)
    b = tcio.restore_train_state(ckpt, 2, template, cfg)
    assert b.points.capacity == (1024 if expand else 600)
    _states_equal(a, b)
    _update(a, cfg, 9)
    _update(b, cfg, 9)
    _states_equal(a, b)
    assert b.sched_points.last_epoch == 3


def test_latest_step_and_resave(scene, tmp_path):
    cfg = scene["cfg"]
    st = ttrainer.create_train_state(
        scene["tparams"], convert.cloud_from_jax(scene["cloud"],
                                                 device="cpu"), cfg)
    ckpt = str(tmp_path / "ckpt")
    assert tcio.latest_step(ckpt) is None
    for step in (5, 20, 10):
        tcio.save_train_state(ckpt, st, step)
    assert tcio.latest_step(ckpt) == 20
    st.step = 7
    tcio.save_train_state(ckpt, st, 20)        # idempotent re-save
    assert sorted(os.listdir(ckpt)) == ["step_10", "step_20", "step_5"]
    back = tcio.restore_train_state(ckpt, 20, st, cfg)
    assert back.step == 7
