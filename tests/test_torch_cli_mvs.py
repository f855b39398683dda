"""The port's command line for MVSNet point generation and joint MVS
training (`gen-points` without `--from-ply`, `train-joint`) on the CPU
(`--device cpu`), each command run through the port's CLI and the JAX
CLI on the same files.

The data: the procedural chair at 64x64 with 4 train views (MVSNet sees
1/4-res images, whose 16x16 give the depth net 4x4 features). The
weights: random checkpoints in the reference's layouts, made from seeds
(`random_mvsnet_checkpoint`, `random_fpn_checkpoint`).

gen-points: the reference's gates leave no point on random weights
(their softmax over depth is flat, under the 0.8 confidence gate): the
JAX CLI fails in `from_arrays`, the port raises its own ValueError.

train-joint --steps 2 at the reference's gate (0.8): the two CLIs draw
their noise from different generators, so they are compared by
structure: the points valid at step 1 (a fresh ProbNet passes none, in
both: ROADMAP §3), the logged keys, and the end, where there is no cloud
to write (the JAX CLI fails in `from_arrays`, the port raises its own
ValueError)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import cli as tcli
from pointnerf2studio_torch.data import procedural as tproc
from pointnerf2studio_torch.models.mvsnet.featurenet import (
    random_fpn_checkpoint)
from pointnerf2studio_torch.models.mvsnet.mvsnet import (
    random_mvsnet_checkpoint)
from pointnerf2studio_tpu import cli as jcli

torch.set_num_threads(1)

DEV = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mvs")
    data = tproc.generate_chair_dataset(str(root / "data"), n_train=4,
                                        n_test=1, hw=(64, 64), seed=1,
                                        device="cpu")
    return {"root": root, "data": data,
            "mvs": random_mvsnet_checkpoint(str(root / "model.ckpt"), 0),
            "fpn": random_fpn_checkpoint(str(root / "best_net_mvs.pth"),
                                         1)}


def run(main, argv):
    out = io.StringIO()
    err = None
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except ValueError as e:
            err = e
    return out.getvalue(), err


def test_gen_points_mvsnet_matches_jax_cli(files):
    """At the reference's gates random weights keep no point in either
    CLI: the reference prints 0 and fails writing its (0, 3)-wide arrays,
    the port raises naming the filters (the clouds of a run with points
    are held in tests/test_torch_pointgen.py)."""
    argv = ["gen-points", "--scene", "chair", "--data", files["data"],
            "--mvsnet-ckpt", files["mvs"], "--fpn-ckpt", files["fpn"],
            "--max-batches", "4"]
    t_out, t_err = run(tcli.main, argv + ["--out", str(
        files["root"] / "t_gen")] + DEV)
    j_out, j_err = run(jcli.main, argv + ["--out", str(
        files["root"] / "j_gen")])
    assert int(j_out.split("generated ")[1].split()[0]) == 0
    assert "cannot reshape" in str(j_err)
    assert "no point survived the filters of 4 view batches" in str(t_err)
    assert not os.path.exists(files["root"] / "t_gen")


def test_train_joint_matches_jax_cli(files):
    """Two steps in each CLI at the reference's gate."""
    import jax
    from pointnerf2studio_tpu.data.blender import load_blender
    from pointnerf2studio_tpu.data.mvs_batches import build_view_batches
    from pointnerf2studio_tpu.train import joint as jj

    argv = ["train-joint", "--scene", "chair", "--data", files["data"],
            "--steps", "2", "--print-freq", "1", "--num-depth", "16"]
    t_dir, j_dir = files["root"] / "t_joint", files["root"] / "j_joint"
    t_out, t_err = run(tcli.main, argv + ["--out", str(t_dir)] + DEV)
    j_out, j_err = run(jcli.main, argv + ["--out", str(j_dir)])
    # the points the gate passed at step 1: the port prints its count;
    # the reference's, from its first batch, state and key
    n_t = int(t_out.split("step 1: ")[1].split()[0])
    ds = load_blender(files["data"], "train")
    batches, _, _, _ = build_view_batches(ds, num_src=2)
    vb = batches[int(np.random.default_rng(0).integers(len(batches)))]
    mvs = jj.init_joint_params(jax.random.PRNGKey(0), num_views=3)
    kgen, _ = jax.random.split(jax.random.PRNGKey(1))
    g = jj.generate_points_diff(
        mvs, *(jax.numpy.asarray(a) for a in (
            vb.images, vb.intrinsics, vb.w2cs, vb.c2ws,
            np.asarray(vb.near_far, np.float32))), key=kgen, num_depth=16)
    n_j = int(np.asarray(g["valid"]).sum())
    assert n_t == n_j == 0
    # the logs have the same records
    recs = []
    for d in (t_dir, j_dir):
        with open(d / "train_metrics.jsonl") as f:
            recs.append([json.loads(ln) for ln in f])
    assert [sorted(r) for r in recs[0]] == [sorted(r) for r in recs[1]]
    assert [r["step"] for r in recs[0]] == [1, 2]
    # nothing to write: the gate passed no point
    assert "cannot reshape" in str(j_err)
    assert "no generated point passes the prob_filter gate" in str(t_err)
    assert not os.path.exists(t_dir / "2_net_ray_marching.pth")
