"""The port's command line (pointnerf2studio_torch/cli.py) end to end on
the CPU (`--device cpu`), the flow of the reference's
tests/test_cli_e2e.py on a 16x16 procedural chair: gen-points from a PLY
and a comb file, train 3 steps (with evaluation images), eval and eval
--fast, visualize, edit, evaluate-images, grow-video and a GIF
render-video. Each command is held against the JAX CLI on the same
files: gen-points gives the same cloud (positions, colours and live
points exactly; the random features differ, jax.random against a
torch.Generator); the JAX reader takes the port's checkpoint; eval and
eval --fast on that checkpoint give the JAX CLI's metrics (SSIM within
1e-4 and RMSE within 1e-5, tests/test_torch_evaluator.py's bound) and
images within one 8-bit level; evaluate-images over the eval output and
a ground truth composited onto white gives the JAX CLI's metrics within
rtol 1e-9 and eval's PSNR within what 8-bit rounding can move it;
render-video's frames (both routes of the port against the JAX CLI's
legacy route), visualize's PLY and train's files and checkpoint layout
are the JAX CLI's. `train --num-devices 2 --device cpu` runs two gloo
ranks and writes what the single-device train writes; on the card, with
fewer cards than ranks, it raises "need N devices, have M". MVSNet's
`gen-points` and `train-joint` are held in tests/test_torch_cli_mvs.py."""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from pinned_weights import pinned_reference_weights  # noqa: F401

from pointnerf2studio_torch import cli as tcli
from pointnerf2studio_torch.data import blender as tblender
from pointnerf2studio_torch.data import procedural as tproc
from pointnerf2studio_torch.data.synthetic import make_chair_scene
from pointnerf2studio_torch.train.evaluator import save_image
from pointnerf2studio_torch.utils import checkpoint_io as tcio
from pointnerf2studio_tpu import cli as jcli
from pointnerf2studio_tpu.utils import checkpoint_io as jcio

torch.set_num_threads(1)

DEV = ["--device", "cpu"]


N_PLY = 10_000
CAPACITY = "16384"


def write_chair_ply(path):
    """N_PLY points on the procedural chair's surface, with its albedo."""
    cloud = make_chair_scene(n_points=N_PLY, seed=0, device="cpu").cloud
    rec = np.zeros(N_PLY, [("xyz", "<f4", 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = cloud.xyz.numpy()
    rec["rgb"] = (cloud.points_color.numpy().clip(0, 1) * 255).astype(
        np.uint8)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex "
                 f"{N_PLY}\nproperty float x\nproperty float y\n"
                 "property float z\nproperty uchar red\nproperty uchar "
                 "green\nproperty uchar blue\nend_header\n").encode())
        rec.tofile(f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A dataset, gen-points and a 3-step train with evaluation images.
    The train starts from gen-points' checkpoint with its density head's
    bias raised by 30: random init leaves that ReLU head all negative
    (data/synthetic.py raises it for the same reason), and the chair must
    show in the renders that the commands are compared on."""
    root = tmp_path_factory.mktemp("cli")
    data = tproc.generate_chair_dataset(str(root / "data"), n_train=2,
                                        n_test=1, hw=(16, 16), seed=1,
                                        device="cpu")
    ply = str(root / "init.ply")
    write_chair_ply(ply)
    comb = root / "extra.txt"
    comb.write_text("0.05;0.05;0.05\n-0.05;-0.05;-0.05\n")
    gen = ["gen-points", "--scene", "chair", "--data", data, "--from-ply",
           ply, "--comb-file", str(comb), "--capacity", CAPACITY]
    gen_dir = str(root / "gen")
    tcli.main([*gen, "--out", gen_dir, *DEV])
    out = str(root / "run")
    os.makedirs(out)
    sd = torch.load(os.path.join(gen_dir, "0_net_ray_marching.pth"),
                    map_location="cpu", weights_only=True)
    sd["aggregator.alpha_branch.0.bias"] += 30.0
    torch.save(sd, os.path.join(out, "0_net_ray_marching.pth"))
    tcli.main(["train", "--scene", "chair", "--data", data, "--point-cloud",
               out, "--out", out, "--max-steps", "3", "--rays-per-batch",
               "64", "--capacity", CAPACITY, "--eval-views", "1",
               "--eval-freq", "3", "--eval-images", *DEV])
    return {"root": root, "data": data, "out": out, "gen": gen,
            "gen_dir": gen_dir}


def test_gen_points_from_ply_and_comb(run):
    sd = tcio.load_torch_state_dict(
        os.path.join(run["gen_dir"], "0_net_ray_marching.pth"))
    xyz = sd["neural_points.xyz"]
    # voxel downsampling merges points a voxel apart (and may merge a comb
    # row into a nearby point), so the comb coordinates must survive
    # within a voxel
    assert 0.9 * N_PLY < xyz.shape[0] <= N_PLY + 2
    for p in ((0.05, 0.05, 0.05), (-0.05, -0.05, -0.05)):
        assert np.linalg.norm(xyz - np.array(p, np.float32), axis=1).min() \
            < 0.05
    assert sd["neural_points.points_embeding"].shape == (1, xyz.shape[0], 32)
    assert "aggregator.block1.0.weight" in sd


def test_gen_points_matches_jax_cli(run):
    """The JAX CLI's gen-points on the same files: the same positions,
    colours and live points; the features are the same kind of draw."""
    jout = str(run["root"] / "jax_gen")
    jcli.main([*run["gen"], "--out", jout])
    want = jcio.load_torch_state_dict(os.path.join(jout,
                                                   "0_net_ray_marching.pth"))
    got = tcio.load_torch_state_dict(
        os.path.join(run["gen_dir"], "0_net_ray_marching.pth"))
    for k in ("xyz", "points_color", "points_conf", "points_dir"):
        np.testing.assert_array_equal(got[f"neural_points.{k}"],
                                      want[f"neural_points.{k}"], err_msg=k)
    e_t = got["neural_points.points_embeding"]
    e_j = want["neural_points.points_embeding"]
    assert e_t.shape == e_j.shape
    # the reference's "rand" features: uniform in [-0.5, 0.5)
    for e in (e_t, e_j):
        assert -0.5 <= e.min() and e.max() < 0.5
    assert abs(float(e_t.mean()) - float(e_j.mean())) < 0.05
    for k in want:
        assert got[k].shape == want[k].shape, k


def test_train_writes_checkpoints_and_eval_images(run):
    out = run["out"]
    for name in ("3_net_ray_marching.pth", "3_states.pth", "log.txt",
                 "train_metrics.jsonl", "evalimg_000003/eval_000.png"):
        assert os.path.exists(os.path.join(out, name)), name
    states = tcio.load_states_file(os.path.join(out, "3_states.pth"))
    assert states["total_steps"] == 3


def test_jax_reads_the_port_checkpoint(run):
    path = os.path.join(run["out"], "3_net_ray_marching.pth")
    j_params, j_pts = jcio.load_reference_checkpoint(path)
    from pointnerf2studio_torch.data.presets import get_preset
    t_params, t_pts = tcio.load_reference_checkpoint(
        path, get_preset("chair").agg, device="cpu")
    for k in ("xyz", "points_embeding", "points_conf", "points_dir",
              "points_color", "Rw2c"):
        np.testing.assert_array_equal(np.asarray(getattr(j_pts, k)),
                                      getattr(t_pts, k).numpy(), err_msg=k)
    w_j = np.asarray(j_params["mlp_base"][0]["kernel"])
    w_t = t_params.mlp_base[0].weight.detach().numpy()
    np.testing.assert_array_equal(w_j, w_t.T)


def printed(main, argv) -> str:
    """What `main(argv)` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def last_dict(text: str) -> dict:
    return ast.literal_eval(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def evals(run):
    """eval (with images) and eval --fast through both CLIs on the port's
    checkpoint, and the test view composited onto white as an 8-bit PNG
    (the dataset's own PNGs are RGBA, and evaluate-images reads their RGB
    alone: ROADMAP section 3)."""
    root = run["root"]
    common = ["eval", "--scene", "chair", "--data", run["data"],
              "--checkpoint", run["out"], "--eval-views", "1"]
    out = {}
    for pkg, main, dev in (("torch", tcli.main, DEV), ("jax", jcli.main, [])):
        ev_dir = str(root / f"ev_{pkg}")
        out[pkg] = {
            "legacy": last_dict(printed(main, [*common, "--out", ev_dir,
                                               *dev])),
            "fast": last_dict(printed(main, [*common, "--fast", *dev])),
            "dir": ev_dir}
    gt_dir = str(root / "gt_white")
    save_image(tblender.load_blender(run["data"], "test").images[0],
               os.path.join(gt_dir, "r_0.png"))
    out["gt_dir"] = gt_dir
    return out


def test_eval_and_eval_fast(evals):
    m, mf = evals["torch"]["legacy"], evals["torch"]["fast"]
    assert set(m) == {"psnr", "ssim", "rmse"} and np.isfinite(m["psnr"])
    assert os.path.isfile(os.path.join(evals["torch"]["dir"], "eval_000.png"))
    # the legacy float32 route and the fast route on the same weights
    assert abs(mf["psnr"] - m["psnr"]) < 0.5
    # evaluate-images over the eval output and the white-composited ground
    # truth: eval's PSNR, moved at most by the 8-bit truncation of both
    # images (each value by less than 1/255, so the RMSE by less than
    # 1/255)
    mi = json.loads(printed(tcli.main, [
        "evaluate-images", "--pred", evals["torch"]["dir"], "--gt",
        evals["gt_dir"]]).strip().splitlines()[-1])
    assert mi["n_images"] == 1
    bound = 20 * np.log10(1 + (1 / 255) / min(m["rmse"], mi["rmse"]))
    assert abs(mi["psnr"] - m["psnr"]) <= bound, (mi, m, bound)


@pytest.mark.parametrize("route", ["legacy", "fast"])
def test_eval_matches_jax_cli(evals, route):
    """The same checkpoint and data through both CLIs' eval: the metrics
    within tests/test_torch_evaluator.py's bound for the legacy route
    (SSIM 1e-4, RMSE 1e-5; PSNR then within 1e-3 dB at these RMSEs)."""
    got, want = evals["torch"][route], evals["jax"][route]
    assert set(got) == set(want)
    assert abs(got["ssim"] - want["ssim"]) < 1e-4, (got, want)
    assert abs(got["rmse"] - want["rmse"]) < 1e-5, (got, want)
    assert abs(got["psnr"] - want["psnr"]) < 1e-3, (got, want)


def test_eval_images_match_jax_cli(evals):
    from PIL import Image
    a, b = (np.asarray(Image.open(os.path.join(evals[p]["dir"],
                                               "eval_000.png")), np.int16)
            for p in ("torch", "jax"))
    assert a.shape == b.shape == (16, 16, 3)
    # float32 canvases a few ulp apart truncate to 8 bits at most a level
    # apart
    assert np.abs(a - b).max() <= 1


def test_evaluate_images_matches_jax_cli(evals):
    argv = ["evaluate-images", "--pred", evals["torch"]["dir"], "--gt",
            evals["gt_dir"]]
    got = json.loads(printed(tcli.main, argv).strip().splitlines()[-1])
    want = json.loads(printed(jcli.main, argv).strip().splitlines()[-1])
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)


def test_visualize(run, capsys):
    viz = str(run["root"] / "viz")
    tcli.main(["visualize", "--checkpoint", run["out"], "--out", viz])
    text = capsys.readouterr().out
    assert "points.ply" in text and "conf: min" in text
    with open(os.path.join(viz, "points.ply"), "rb") as f:
        head = f.read(200)
    assert b"element vertex" in head
    from pointnerf2studio_torch.data.pointcloud_init import load_ply
    d = load_ply(os.path.join(viz, "points.ply"))
    sd = tcio.load_torch_state_dict(
        os.path.join(run["out"], "3_net_ray_marching.pth"))
    np.testing.assert_array_equal(d["xyz"], sd["neural_points.xyz"])


def test_edit_merges_parts(run):
    ckpt = os.path.join(run["out"], "3_net_ray_marching.pth")
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (1.0, 0.0, 0.0)
    np.save(run["root"] / "shift.npy", shift)
    np.save(run["root"] / "ident.npy", np.eye(4, dtype=np.float32))
    merged = str(run["root"] / "edit" / "merged.pth")
    tcli.main(["edit", "--parts", ckpt, ckpt, "--transforms",
               str(run["root"] / "ident.npy"), str(run["root"] / "shift.npy"),
               "--out", merged])
    sd = tcio.load_torch_state_dict(merged)
    one = tcio.load_torch_state_dict(ckpt)["neural_points.xyz"]
    n = one.shape[0]
    np.testing.assert_array_equal(sd["neural_points.xyz"][:n], one)
    np.testing.assert_allclose(sd["neural_points.xyz"][n:], one + shift[:3, 3],
                               rtol=0, atol=1e-6)
    assert sd["neural_points.Rw2c"].shape == (2 * n, 3, 3)


def orbit_frames(main, run, name, argv):
    import imageio
    vid = str(run["root"] / f"orbit_{name}.gif")
    printed(main, ["render-video", "--scene", "chair", "--data",
                   run["data"], "--checkpoint", run["out"], "--out", vid,
                   *argv])
    return np.stack(imageio.mimread(vid)).astype(np.int16)


def test_grow_video_and_render_video(run, capsys):
    gif = str(run["root"] / "grow.gif")
    tcli.main(["grow-video", "--run", run["out"], "--out", gif])
    assert "(1 frames)" in capsys.readouterr().out
    assert os.path.getsize(gif) > 0
    # the interpolated path on the legacy route, against the JAX CLI's:
    # --frames 6 puts 6 // 3 frames between each pair of the 2 train views
    path = ["--path", "interpolate", "--frames", "6"]
    got = orbit_frames(tcli.main, run, "torch_interp", [*path, *DEV])
    want = orbit_frames(jcli.main, run, "jax_interp", path)
    assert got.shape == want.shape == (4, 16, 16, 3)
    d = np.abs(got - want)
    assert d.max() <= 2 and d.mean() < 0.1, (d.max(), d.mean())


@pytest.fixture(scope="module")
def jax_orbit(run):
    """The JAX CLI's render-video on its legacy route. Its --fast route is
    not the reference here: its frame renderer draws every frame after
    the first with the first frame's camera (ROADMAP section 3)."""
    return orbit_frames(jcli.main, run, "jax", ["--frames", "2"])


@pytest.mark.parametrize("route", ["legacy", "fast"])
def test_render_video_matches_jax_cli(run, jax_orbit, route):
    """The same orbit through the port's render-video and the JAX CLI's:
    the GIFs' frames within 2 levels at most and 0.1 on average (the
    canvases agree to float32 rounding; the GIF's palette can move a
    pixel by a level), both frames showing the chair."""
    got = orbit_frames(tcli.main, run, f"torch_{route}",
                       ["--frames", "2",
                        *(["--fast"] if route == "fast" else []), *DEV])
    assert got.shape == jax_orbit.shape == (2, 16, 16, 3)
    d = np.abs(got - jax_orbit)
    assert d.max() <= 2 and d.mean() < 0.1, (d.max(), d.mean())
    assert ((got < 250).any(axis=-1).sum(axis=(1, 2)) > 10).all()


def test_visualize_matches_jax_cli(run):
    out = {}
    for pkg, main in (("torch", tcli.main), ("jax", jcli.main)):
        viz = str(run["root"] / f"viz_{pkg}")
        text = printed(main, ["visualize", "--checkpoint", run["out"],
                              "--out", viz])
        with open(os.path.join(viz, "points.ply"), "rb") as f:
            out[pkg] = ([ln for ln in text.splitlines()
                         if ln.startswith("conf:")], f.read())
    assert out["torch"] == out["jax"]
    assert len(out["torch"][0]) == 1


def test_train_matches_jax_cli(run):
    """The JAX CLI's train from the same gen-points checkpoint, with the
    same flags: the same files, the same checkpoint layout and the same
    step count. (Their rays differ: each draws them on its own device
    generator.)"""
    jout = str(run["root"] / "jax_train")
    jcli.main(["train", "--scene", "chair", "--data", run["data"],
               "--point-cloud", os.path.join(run["out"],
                                             "0_net_ray_marching.pth"),
               "--out", jout, "--max-steps", "3", "--rays-per-batch", "64",
               "--capacity", CAPACITY, "--eval-views", "1", "--eval-freq",
               "3", "--eval-images"])

    def files(d):
        """The reference-format files: the resumable state under ckpt/ is
        each package's own format (orbax, torch.save)."""
        return {os.path.relpath(os.path.join(r, f), d)
                for r, _, fs in os.walk(d) for f in fs
                if not os.path.relpath(r, d).startswith("ckpt")}

    # the port's run directory also holds the start, the raised
    # gen-points checkpoint
    assert files(run["out"]) - {"0_net_ray_marching.pth"} == files(jout)
    for d in (run["out"], jout):
        assert os.path.isdir(os.path.join(d, "ckpt", "step_3"))
    got = tcio.load_torch_state_dict(
        os.path.join(run["out"], "3_net_ray_marching.pth"))
    want = jcio.load_torch_state_dict(os.path.join(jout,
                                                   "3_net_ray_marching.pth"))
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    assert tcio.load_states_file(os.path.join(run["out"], "3_states.pth"))[
        "total_steps"] == jcio.load_states_file(
            os.path.join(jout, "3_states.pth"))["total_steps"] == 3
    with open(os.path.join(run["out"], "train_metrics.jsonl")) as f:
        t_rec = [json.loads(ln) for ln in f]
    with open(os.path.join(jout, "train_metrics.jsonl")) as f:
        j_rec = [json.loads(ln) for ln in f]
    # a record that closes no steps (at the step of the record before it:
    # here the final metrics) has no it_per_sec in the port, where the
    # reference writes 0 (ROADMAP section 3); every other key is the same
    closes = [i == 0 or r["step"] > j_rec[i - 1]["step"]
              for i, r in enumerate(j_rec)]
    assert not all(closes)
    assert all(r["it_per_sec"] == 0 for r, c in zip(j_rec, closes) if not c)
    assert [sorted(r) for r in t_rec] == [
        sorted(k for k in r if c or k != "it_per_sec")
        for r, c in zip(j_rec, closes)]


def test_train_num_devices_on_cpu_ranks(run, tmp_path):
    """train --num-devices 2 --device cpu: two gloo ranks, each running
    fit(mesh=make_mesh(2)); rank 0 writes what the single-device train
    writes (checkpoints, the metrics log with the same records, the
    evaluation images)."""
    out = str(tmp_path / "mesh")
    os.makedirs(out)
    start = os.path.join(run["out"], "0_net_ray_marching.pth")
    with open(start, "rb") as f, \
            open(os.path.join(out, "0_net_ray_marching.pth"), "wb") as g:
        g.write(f.read())
    tcli.main(["train", "--scene", "chair", "--data", run["data"],
               "--point-cloud", out, "--out", out, "--max-steps", "3",
               "--rays-per-batch", "64", "--capacity", CAPACITY,
               "--eval-views", "1", "--eval-freq", "3", "--eval-images",
               "--num-devices", "2", *DEV])

    def files(d):
        return {os.path.relpath(os.path.join(r, f), d)
                for r, _, fs in os.walk(d) for f in fs}

    assert files(out) == files(run["out"])
    for d in (out, run["out"]):
        assert os.path.isdir(os.path.join(d, "ckpt", "step_3"))
    recs = []
    for d in (out, run["out"]):
        with open(os.path.join(d, "train_metrics.jsonl")) as f:
            recs.append([sorted(json.loads(ln)) for ln in f])
    assert recs[0] == recs[1]
    got = tcio.load_torch_state_dict(os.path.join(out,
                                                  "3_net_ray_marching.pth"))
    first = tcio.load_torch_state_dict(start)
    assert not np.array_equal(got["neural_points.points_embeding"],
                              first["neural_points.points_embeding"])


def test_train_num_devices_needs_the_cards():
    """On the card, one GPU a rank: with fewer cards than ranks the CLI
    raises the reference's message and never stacks ranks on one card."""
    have = torch.cuda.device_count()
    if have >= 2:
        pytest.skip("two cards are present: the ranks would run")
    with pytest.raises(ValueError, match=f"need 2 devices, have {have}"):
        tcli.main(["train", "--data", "d", "--point-cloud", "p", "--out",
                   "o", "--num-devices", "2", "--device", "cuda"])


def test_parser_is_the_reference_plus_device():
    """Every command and option of the JAX parser, and --device on the
    commands that compute."""
    def options(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {name: {s for a in sp._actions for s in a.option_strings}
                for name, sp in sub.choices.items()}

    want, got = options(jcli.build_parser()), options(tcli.build_parser())
    assert set(got) == set(want)
    for name in want:
        extra = got[name] - want[name]
        assert want[name] <= got[name], name
        assert extra == ({"--device"} if "--data" in want[name] else set()), \
            name


def test_default_device_is_the_card(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["eval", "--data", run["data"], "--checkpoint", run["out"]])
