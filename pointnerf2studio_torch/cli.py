"""Command-line interface of the PyTorch port.

Port of `pointnerf2studio_tpu/cli.py` (the reference's entry points:
run/train_ft.py, run/gen_pnts.py, run/test_ft.py, run/render_vid.py,
run/editing.py), with one flag the reference lacks: `--device` on the
commands that compute, the card by default (`cuda`), `cpu` to run on the
host:

  python -m pointnerf2studio_torch.cli gen-points --scene chair \
      --data <dir> --mvsnet-ckpt <ckpt> --fpn-ckpt <pth> --out <dir>
  python -m pointnerf2studio_torch.cli gen-points --scene chair \
      --data <dir> --from-ply <ply> --out <dir>
  python -m pointnerf2studio_torch.cli train-joint --scene chair \
      --data <dir> --out <dir>
  python -m pointnerf2studio_torch.cli train --scene chair --data <dir> \
      --point-cloud <ckpt dir> --out <dir>
  python -m pointnerf2studio_torch.cli eval --scene chair --data <dir> \
      --checkpoint <pth or dir> [--fast] [--out <dir>]
  python -m pointnerf2studio_torch.cli render-video --scene chair ...
  python -m pointnerf2studio_torch.cli edit --parts a.pth b.pth ...

Checkpoints are the reference's `<iter>_net_ray_marching.pth`
(`utils/checkpoint_io.py`); a checkpoint's aggregator is read with the
scene preset's AggregatorConfig (`edit`: the default one, which every
preset uses). `visualize` and `edit` read and write files on the host
alone. `gen-points` without `--from-ply` runs MVSNet point generation
(`models/mvsnet/pointgen.py`) and raises ValueError where its filters
leave no point; `train-joint` trains the MVS stack and the fields
together (`train/joint.py`) and prints the points its gate let through at
the first step. `train --num-devices N` (N > 1) spawns N ranks
(parallel/sharding.run_ranks), each running `fit(mesh=make_mesh(N))`: on
the card one GPU a rank over NCCL (with fewer than N cards it raises
"need N devices, have M"), under `--device cpu` N gloo ranks on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os


def _latest_ckpt(path: str) -> str:
    """Newest `<iter>_net_ray_marching.pth` in a directory (reference
    get_latest_epoch semantics, studio_model.py:55-59)."""
    if os.path.isfile(path):
        return path
    cands = glob.glob(os.path.join(path, "*_net_ray_marching.pth"))
    if not cands:
        raise FileNotFoundError(
            f"no *_net_ray_marching.pth under {path}")
    return max(cands, key=lambda p: int(os.path.basename(p).split("_")[0]))


def _device(args):
    from pointnerf2studio_torch.ops._cuda import resolve_device
    return resolve_device(args.device)


def _load_scene(args):
    from pointnerf2studio_torch.data.blender import load_blender
    from pointnerf2studio_torch.data.presets import get_preset

    cfg = get_preset(args.scene)
    if getattr(args, "rays_per_batch", None):
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, rays_per_batch=args.rays_per_batch))
    if getattr(args, "max_steps", None):
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, max_iterations=args.max_steps))
    train_ds = load_blender(args.data, "train", factor=args.factor)
    try:
        eval_ds = load_blender(args.data, "test", factor=args.factor)
    except FileNotFoundError:
        eval_ds = train_ds
    return cfg, train_ds, eval_ds


def _load_checkpoint(path: str, cfg, device, capacity=None):
    from pointnerf2studio_torch.utils import checkpoint_io as cio
    return cio.load_reference_checkpoint(_latest_ckpt(path), cfg.agg,
                                         capacity=capacity, device=device)


def _train(args, dev, mesh=None):
    from pointnerf2studio_torch.train.loop import fit

    cfg, train_ds, eval_ds = _load_scene(args)
    params, points = _load_checkpoint(args.point_cloud, cfg, dev,
                                      capacity=args.capacity)
    if points is None:
        raise SystemExit("checkpoint has no neural_points; run gen-points")
    res = fit(cfg, train_ds, params, points, args.out,
              eval_dataset=eval_ds, eval_views=list(range(args.eval_views)),
              eval_freq=args.eval_freq, tensorboard=args.tensorboard,
              eval_save_images=args.eval_images, mesh=mesh, device=dev)
    if mesh is None or mesh.rank == 0:
        print("final metrics:", res.metrics)


def _train_rank(rank, args, device_type):
    from pointnerf2studio_torch.parallel.sharding import make_mesh
    mesh = make_mesh(args.num_devices,
                     device="cpu" if device_type == "cpu" else None)
    _train(args, mesh.device, mesh)


def cmd_train(args):
    n = args.num_devices
    if n <= 1:
        _train(args, _device(args))
        return
    import torch
    from pointnerf2studio_torch.parallel.sharding import run_ranks
    kind = torch.device(args.device or "cuda").type
    if kind == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"need {n} devices, have {have}")
    run_ranks(_train_rank, n, "nccl" if kind == "cuda" else "gloo",
              (args, kind))


def cmd_eval(args):
    from pointnerf2studio_torch.ops.hash_grid import (
        HashGrid, build_query_grid)
    from pointnerf2studio_torch.train.evaluator import evaluate_dataset

    cfg, train_ds, eval_ds = _load_scene(args)
    params, points = _load_checkpoint(args.checkpoint, cfg, _device(args))
    grid = build_query_grid(points.xyz, points.alive, cfg.query)
    if isinstance(grid, HashGrid) and not args.fast:
        print("hash-grid scene: the legacy eval path is dense-only; "
              "rendering through the fast path")
        args.fast = True
    views = list(range(args.eval_views)) if args.eval_views else None
    m = evaluate_dataset(cfg, params, points, grid, eval_ds, views=views,
                         out_dir=args.out, save_images=bool(args.out),
                         fast=args.fast,
                         bg_src_dataset=(train_ds if cfg.bgmodel.endswith(
                             "plane") else None))
    print(m)


def cmd_render_video(args):
    from pointnerf2studio_torch.ops.hash_grid import (
        HashGrid, build_query_grid)
    from pointnerf2studio_torch.train.evaluator import (
        interpolated_poses, render_video)

    cfg, train_ds, _ = _load_scene(args)
    params, points = _load_checkpoint(args.checkpoint, cfg, _device(args))
    grid = build_query_grid(points.xyz, points.alive, cfg.query)
    fast = args.fast or isinstance(grid, HashGrid)
    poses = None
    if args.path == "interpolate":
        poses = interpolated_poses(train_ds.poses, n_views=args.frames)
    path = render_video(cfg, params, points, grid, train_ds.intrinsics,
                        train_ds.hw, train_ds.near, train_ds.far,
                        args.out, n_frames=args.frames, fast=fast,
                        poses=poses)
    print("wrote", path)


def _init_params(args, cfg, dev):
    from pointnerf2studio_torch.models.aggregator import Aggregator
    from pointnerf2studio_torch.utils import checkpoint_io as cio
    if args.init_mlp:
        return cio.import_aggregator_params(
            cio.load_torch_state_dict(args.init_mlp), cfg.agg, device=dev)
    return Aggregator(cfg.agg, seed=0, device=dev)


def cmd_gen_points(args):
    """MVSNet point generation from the train views (reference
    run/gen_pnts.py; `--mvsnet-ckpt` in model_000014.ckpt's layout,
    `--fpn-ckpt` in best_net_mvs.pth's), or the COLMAP / PLY
    initialisation with `--from-ply` (reference w_colmap_n360 family:
    load_init_points, nerf_synth360_ft_dataset.py:358-375)."""
    import numpy as np

    from pointnerf2studio_torch.data.presets import get_preset
    from pointnerf2studio_torch.utils import checkpoint_io as cio

    cfg = get_preset(args.scene)
    dev = _device(args)
    out_path = os.path.join(args.out, "0_net_ray_marching.pth")

    if args.from_ply:
        from pointnerf2studio_torch.data.pointcloud_init import (
            init_cloud_from_points, load_ply)
        d = load_ply(args.from_ply)
        if args.comb_file:
            # reference --comb_file: extra xyz rows from a ';'-delimited
            # txt are concatenated onto the PLY cloud
            # (nerf_synth360_ft_dataset.py:369-374)
            extra = np.loadtxt(args.comb_file, delimiter=";", ndmin=2)
            d["xyz"] = np.concatenate(
                [d["xyz"], extra[:, :3].astype(np.float32)], 0)
            if d["color"] is not None:
                pad = np.full((extra.shape[0], 3), 0.5, np.float32)
                d["color"] = np.concatenate([d["color"], pad], 0)
        cloud = init_cloud_from_points(
            d["xyz"], d["color"], feat_dim=cfg.agg.point_features_dim,
            vox_res=args.vox_res, ranges=cfg.query.ranges,
            capacity=args.capacity, point_noise=args.point_noise,
            device=dev)
    else:
        from pointnerf2studio_torch.data.blender import load_blender
        from pointnerf2studio_torch.data.mvs_batches import (
            build_view_batches)
        from pointnerf2studio_torch.models import neural_points as npts
        from pointnerf2studio_torch.models.mvsnet import (
            load_fpn_params, load_mvsnet_params)
        from pointnerf2studio_torch.models.mvsnet.pointgen import (
            PointGenConfig, generate_point_cloud)

        ds = load_blender(args.data, "train", factor=args.factor)
        mvs_params = load_mvsnet_params(args.mvsnet_ckpt, device=dev)
        fpn_params = load_fpn_params(args.fpn_ckpt, device=dev)
        batches, alphas, aK, aE = build_view_batches(
            ds, num_src=args.num_src, max_batches=args.max_batches,
            pairing=args.pairing)
        pg = PointGenConfig(vox_res=args.vox_res, ranges=cfg.query.ranges)
        pc = generate_point_cloud(mvs_params, fpn_params, batches,
                                  alphas=alphas, alpha_intrinsics=aK,
                                  alpha_w2cs=aE, cfg=pg)
        print("generated", pc["xyz"].shape[0], "points")
        cloud = npts.from_arrays(pc["xyz"], pc["embedding"], pc["conf"],
                                 pc["dir"], pc["color"],
                                 capacity=args.capacity, device=dev)
    os.makedirs(args.out, exist_ok=True)
    cio.export_torch_checkpoint(_init_params(args, cfg, dev), cloud,
                                out_path)
    print("wrote", out_path)


def cmd_train_joint(args):
    """Joint MVS + render training (reference mode 0, learned depth):
    the point cloud regenerated from the MVS nets every step and both
    stacks trained end to end (reference:
    mvs_points_volumetric_model.py:38-45 + train_ft.py with --mode 0), at
    the reference's prob_filter gate of 0.8. FeatureNet / premlp come
    from --net-mvs where given (mvs_points_model.py:79). The batches are
    drawn as the reference draws them (numpy, seed 0); the depth and
    jitter noise from a torch.Generator seeded 0 on the device. Writes
    the last step's generated cloud, valid points only, with the fields
    as `<steps>_net_ray_marching.pth`, and raises ValueError where no
    point is valid."""
    import numpy as np
    import torch

    from pointnerf2studio_torch.data.blender import load_blender
    from pointnerf2studio_torch.data.mvs_batches import build_view_batches
    from pointnerf2studio_torch.data.presets import get_preset
    from pointnerf2studio_torch.models import neural_points as npts
    from pointnerf2studio_torch.ops.grid import compute_grid_geometry
    from pointnerf2studio_torch.train.joint import (
        MVSTrainBatch, create_joint_state, generate_points_diff,
        load_pretrained_joint_params, make_joint_train_step)
    from pointnerf2studio_torch.utils import checkpoint_io as cio
    from pointnerf2studio_torch.utils.logger import Logger

    cfg = get_preset(args.scene)
    dev = _device(args)
    ds = load_blender(args.data, "train", factor=args.factor)
    batches, _, _, _ = build_view_batches(ds, num_src=args.num_src)
    fields = _init_params(args, cfg, dev)
    nv = args.num_src + 1
    mvs = (load_pretrained_joint_params(0, args.net_mvs, num_views=nv,
                                        device=dev)
           if args.net_mvs else None)
    state = create_joint_state(fields, cfg, num_views=nv, mvs_lr=args.mvs_lr,
                               mvs=mvs, seed=0, device=dev)
    r = cfg.query.ranges
    rmin, dims = compute_grid_geometry(
        np.asarray(r[:3]), np.asarray(r[3:]), cfg.query)
    step_fn = make_joint_train_step(cfg, rmin, dims, mvs_lr=args.mvs_lr,
                                    num_depth=args.num_depth)
    os.makedirs(args.out, exist_ok=True)
    logger = Logger(args.out)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    R = cfg.train.rays_per_batch
    h, w = ds.hw

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    for step in range(1, args.steps + 1):
        vi = int(rng.integers(len(batches)))
        vb = batches[vi]
        xs = rng.integers(0, w, R)
        ys = rng.integers(0, h, R)
        raydirs = ds.raydirs(vi, np.stack([xs, ys], -1))
        batch = MVSTrainBatch(
            images=t(vb.images), intrinsics=t(vb.intrinsics),
            w2cs=t(vb.w2cs), c2ws=t(vb.c2ws), near_far=t(vb.near_far),
            campos=t(ds.campos(vi)), camrotc2w=t(ds.camrotc2w(vi)),
            raydirs=t(raydirs), gt_rgb=t(ds.images[vi, ys, xs]))
        aux = step_fn(state, batch, generator=gen)
        if step == 1:
            print(f"step 1: {int(aux['n_valid'])} of "
                  f"{(h // 4) * (w // 4)} generated points valid at the "
                  f"prob_filter gate")
        logger.accumulate({k: v for k, v in aux.items() if k != "n_valid"})
        if step % args.print_freq == 0:
            logger.flush(step)
    # export the final generated cloud in the reference checkpoint format
    # (the mode-0 handoff artifact, gen_pnts.py:36-160)
    vb = batches[0]
    with torch.no_grad():
        g = generate_points_diff(
            state.mvs, t(vb.images), t(vb.intrinsics), t(vb.w2cs),
            t(vb.c2ws), t(vb.near_far), num_depth=args.num_depth)
    valid = g["valid"].cpu().numpy()
    if not valid.any():
        # the reference's from_arrays fails here on the empty cloud
        raise ValueError(
            f"train-joint: no generated point passes the prob_filter gate "
            f"after {args.steps} steps, so there is no cloud to write (a "
            f"fresh ProbNet's depth probability sits near 1/"
            f"{args.num_depth} a bin, under the gate's 0.8)")
    arrays = [g[k].cpu().numpy()[valid] for k in
              ("xyz", "embedding", "conf", "dir", "color")]
    cloud = npts.from_arrays(*arrays, device=dev)
    out_path = os.path.join(args.out, f"{args.steps}_net_ray_marching.pth")
    cio.export_torch_checkpoint(state.fields.requires_grad_(False), cloud,
                                out_path)
    print("wrote", out_path)


def cmd_evaluate_images(args):
    """Metrics over rendered-vs-GT PNG directories (reference:
    run/evaluate.py:102-110)."""
    import json

    from pointnerf2studio_torch.utils.metrics import metrics_over_dirs
    m = metrics_over_dirs(args.pred, args.gt)
    print(json.dumps(m))


def cmd_grow_video(args):
    """Stitch the per-evaluation images a training run saved
    (fit(eval_save_images=True) -> out_dir/evalimg_<step>/eval_NNN.png)
    into a chronological growth video (the reference's
    run/vis_grow_train.py render_grow, :36-60). A GIF where the output
    ends in .gif, else imageio's video writer, which raises where no video
    backend is installed."""
    import imageio
    import numpy as np
    from PIL import Image

    dirs = sorted(glob.glob(os.path.join(args.run, "evalimg_*")))
    frames = []
    for d in dirs:
        p = os.path.join(d, f"eval_{args.view:03d}.png")
        if os.path.exists(p):
            frames.append(np.asarray(Image.open(p).convert("RGB")))
    if not frames:
        raise SystemExit(
            f"no evalimg_*/eval_{args.view:03d}.png under {args.run} - "
            "train with --eval-images (fit eval_save_images=True)")
    out = args.out or os.path.join(
        args.run, f"grow_video_{args.view:04d}.gif")
    if out.endswith(".gif"):
        imageio.mimwrite(out, frames, duration=1000.0 / args.fps, loop=0)
    else:
        imageio.mimwrite(out, frames, fps=args.fps, quality=8)
    print(f"wrote {out} ({len(frames)} frames)")


def cmd_visualize(args):
    """Neural-point-cloud inspection on the host: a PLY export and axis
    projections (reference: run/visualize.py and the visualizer's point
    dumps, utils/visualizer.py:97-121; headless, so the artifacts are
    files)."""
    import numpy as np

    from pointnerf2studio_torch.utils import checkpoint_io as cio

    cloud = cio.import_neural_points(cio.load_torch_state_dict(
        _latest_ckpt(args.checkpoint)), device="cpu")
    alive = cloud.alive.numpy()
    xyz = cloud.xyz.numpy()[alive]
    color = np.clip(cloud.points_color.numpy(), 0.0, 1.0)[alive]
    conf = cloud.points_conf.numpy()[:, 0][alive]
    os.makedirs(args.out, exist_ok=True)
    if xyz.shape[0] == 0:
        # a freshly pruned or empty checkpoint: min(), mean() and
        # rng.choice(0) of nothing would raise
        print("0 alive points; skipping stats and projections")
        return

    ply = os.path.join(args.out, "points.ply")
    rgb8 = (color * 255).astype(np.uint8)
    with open(ply, "wb") as f:
        hdr = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {xyz.shape[0]}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n")
        f.write(hdr.encode())
        rec = np.zeros(xyz.shape[0],
                       dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        rec["xyz"], rec["rgb"] = xyz.astype(np.float32), rgb8
        rec.tofile(f)
    print("wrote", ply, f"({xyz.shape[0]} points)")

    # three orthographic scatter projections coloured by point colour
    try:
        import matplotlib
    except ImportError:
        print("matplotlib unavailable; skipped projections.png")
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, (a, b), name in zip(axes, [(0, 1), (0, 2), (1, 2)],
                                    ["xy", "xz", "yz"]):
            sel = np.random.default_rng(0).choice(
                xyz.shape[0], min(100_000, xyz.shape[0]), replace=False)
            ax.scatter(xyz[sel, a], xyz[sel, b], s=0.1, c=color[sel])
            ax.set_title(name)
            ax.set_aspect("equal")
        out_png = os.path.join(args.out, "projections.png")
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print("wrote", out_png)
    print(f"conf: min {conf.min():.3f} mean {conf.mean():.3f} "
          f"max {conf.max():.3f}")


def cmd_edit(args):
    from pointnerf2studio_torch.edit import load_and_merge_parts
    from pointnerf2studio_torch.utils import checkpoint_io as cio

    params, merged = load_and_merge_parts(args.parts, args.transforms,
                                          device="cpu")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cio.export_torch_checkpoint(params, merged, args.out)
    print("wrote merged scene:", args.out, f"({int(merged.num_alive)} "
          "points)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pointnerf2studio_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="chair")
        sp.add_argument("--data", required=True)
        sp.add_argument("--factor", type=int, default=1)
        sp.add_argument("--eval-views", type=int, default=0)
        sp.add_argument("--device", default=None,
                        help="torch device to run on (default: the card, "
                             "cuda; cpu runs on the host)")

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--point-cloud", required=True,
                   help="dir or file with *_net_ray_marching.pth")
    t.add_argument("--out", required=True)
    t.add_argument("--max-steps", type=int, default=None)
    t.add_argument("--rays-per-batch", type=int, default=None)
    t.add_argument("--capacity", type=int, default=None)
    t.add_argument("--eval-freq", type=int, default=0)
    t.add_argument("--num-devices", type=int, default=1)
    t.add_argument("--tensorboard", action="store_true",
                   help="also export scalars as tensorboard events "
                        "(reference visualizer.py:176-182)")
    t.add_argument("--eval-images", action="store_true",
                   help="save eval view renders per eval step "
                        "(evalimg_<step>/ dirs; input to grow-video)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    common(e)
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--out", default=None)
    e.add_argument("--fast", action="store_true",
                   help="fat-cache fast render path (eval semantics)")
    e.set_defaults(fn=cmd_eval)

    v = sub.add_parser("render-video")
    common(v)
    v.add_argument("--checkpoint", required=True)
    v.add_argument("--out", required=True)
    v.add_argument("--frames", type=int, default=60)
    v.add_argument("--fast", action="store_true",
                   help="fat-cache fast render path (eval semantics)")
    v.add_argument("--path", choices=("spherical", "interpolate"),
                   default="spherical",
                   help="camera path: spherical orbit, or the "
                        "reference's dataset-pose interpolation "
                        "(mvs_utils.gen_render_path)")
    v.set_defaults(fn=cmd_render_video)

    g = sub.add_parser("gen-points")
    common(g)
    g.add_argument("--out", required=True)
    g.add_argument("--mvsnet-ckpt", default=None)
    g.add_argument("--fpn-ckpt", default=None)
    g.add_argument("--from-ply", default=None,
                   help="init from a COLMAP/PLY point cloud instead of "
                        "running MVSNet")
    g.add_argument("--init-mlp", default=None)
    g.add_argument("--comb-file", default=None,
                   help="';'-delimited txt of extra xyz rows appended "
                        "to the --from-ply cloud (reference --comb_file)")
    g.add_argument("--point-noise", default="",
                   help="jitter loaded positions once at init, e.g. "
                        "pointgaussian_0.1 (reference --point_noise)")
    g.add_argument("--num-src", type=int, default=2)
    g.add_argument("--pairing", default="nearest",
                   choices=("nearest", "triangles"),
                   help="MVS view-triple selection; 'triangles' = the "
                        "reference's camera-rig BPA triangulation")
    g.add_argument("--max-batches", type=int, default=None)
    g.add_argument("--vox-res", type=int, default=320)
    g.add_argument("--capacity", type=int, default=None)
    g.set_defaults(fn=cmd_gen_points)

    tj = sub.add_parser("train-joint",
                        help="joint MVS+render training (reference "
                             "mode 0, learned depth)")
    common(tj)
    tj.add_argument("--out", required=True)
    tj.add_argument("--net-mvs", default=None,
                    help="pretrained best_net_mvs.pth to seed "
                         "FeatureNet/premlp")
    tj.add_argument("--init-mlp", default=None)
    tj.add_argument("--num-src", type=int, default=2)
    tj.add_argument("--mvs-lr", type=float, default=5e-4)
    tj.add_argument("--num-depth", type=int, default=128)
    tj.add_argument("--steps", type=int, default=1000)
    tj.add_argument("--print-freq", type=int, default=50)
    tj.set_defaults(fn=cmd_train_joint)

    ev = sub.add_parser("evaluate-images",
                        help="metrics over rendered/GT PNG dirs")
    ev.add_argument("--pred", required=True)
    ev.add_argument("--gt", required=True)
    ev.set_defaults(fn=cmd_evaluate_images)

    vz = sub.add_parser("visualize",
                        help="export PLY + projection PNG of a "
                             "checkpoint's neural points")
    vz.add_argument("--checkpoint", required=True)
    vz.add_argument("--out", required=True)
    vz.set_defaults(fn=cmd_visualize)

    gv = sub.add_parser(
        "grow-video",
        help="assemble per-eval-step images from a training run into a "
             "growth video (reference run/vis_grow_train.py)")
    gv.add_argument("--run", required=True,
                    help="fit() out dir containing evalimg_* step dirs "
                         "(train with eval_save_images/--eval-images)")
    gv.add_argument("--view", type=int, default=0)
    gv.add_argument("--out", default=None,
                    help="output video path (default "
                         "<run>/grow_video_<view>.gif)")
    gv.add_argument("--fps", type=float, default=3.0)
    gv.set_defaults(fn=cmd_grow_video)

    ed = sub.add_parser("edit")
    ed.add_argument("--parts", nargs="+", required=True)
    ed.add_argument("--transforms", nargs="*", default=None,
                    help="per-part 4x4 .npy transform files")
    ed.add_argument("--out", required=True)
    ed.set_defaults(fn=cmd_edit)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
