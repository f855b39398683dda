"""Traffic kind "joint": the joint MVS + Point-NeRF step (upstream's
`mode 0`), one after another, as `cli.py::cmd_train_joint` builds it:
`train/joint.py::create_joint_state` and `make_joint_train_step` on the
configuration's preset and `mvs` section. Each step regenerates the cloud
from the reference view of a triple (FeatureNet, the plane-sweep cost
volume, CostRegNet and ProbNet, the depth draw, the unprojection, the
feature samples and the premlp), rebuilds the voxel grid on it, renders
`rays_per_step` rays through `render_rays(training=True)`, and takes the
backward and both Adam groups.

The feed (`Feed`): the configuration's ring of views, made once on the
device; each step a reference view drawn on the host from the seed (a
Python int, so nothing is read back from the card) with its two ring
neighbours as sources, and on the device from a torch.Generator of the
seed its pixels (rays and colours), the depth draw `noise` [H/4, W/4]
and the render's `jitter_u` [R, D].

Set-up builds one state and drives it through the window's own step and
feed for `check_steps` steps; the window goes on with that same state.
Correctness: the plain reference (`perfbench/reference/mvs.py`) follows
those first steps from the same weights, batches and draws. Compared:

- `loss_gap`, `grad_gap`, `change_gap`: as the train kind's `gaps` (each
  step's loss, the worst leaf's first gradient, the worst moving leaf's
  change), over the MVS stack's leaves and the tower's;
- `xyz_gap`: the first step's generated positions, the largest |gap| of
  a coordinate over the extent of the configuration's `ranges` box;
- `valid_mismatch`: over the steps, the points whose gate and in-bounds
  flag differ off the pixel grid's outermost ring. The ring's flag is
  decided by rounding (the reference's departure 4): the reference takes
  the program's flags there, so that both render one cloud, and its own
  flips there are read and printed, not compared.

A traced run also records the device time inside the device-side ranges
that torch.profiler mirrors for the program's span `joint.cost_volume`
(none in a program without that span), which `costvol_roofline` reads.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.core import counts, inputs, mvs_counts
from perfbench.kinds.train import gaps
from perfbench.reference import mvs as ref

CHECKS = ("loss_gap", "grad_gap", "change_gap", "xyz_gap", "valid_mismatch")
# tools/readings.py's modes: the program against the reference, and the
# control (the reference with TF32 in its convolutions and matmuls) in the
# program's place
MODES = ("program", "control")
# the CPU tests' tiny traffic (perfbench/tests/tiny.py)
TINY_TRAFFIC = {"rays_per_step": 64, "trace_seconds": 1.0}
COSTVOL_SPAN = "joint.cost_volume"


class Feed:
    """One step's batch after another, drawn as the module docstring
    says."""

    def __init__(self, cfg: dict, rays: int, seed: int, device):
        from pointnerf2studio_torch.train.joint import MVSTrainBatch
        self.Batch = MVSTrainBatch
        cam, m = cfg["camera"], cfg["mvs"]
        self.imgs, poses = inputs.make_views(cfg, cfg["scene"], seed, device)
        self.V, self.H, self.W = self.imgs.shape[:3]
        self.f, self.R = float(cam["focal"]), rays
        self.D = cfg["query"]["z_depth_dim"]
        self.n_src = m["num_views"] - 1
        self.rng = inputs.sub_rng(seed, 6)
        self.g = torch.Generator(device=device)
        self.g.manual_seed(inputs.torch_seed(seed, 7))

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.c2w = dev(poses)
        self.w2c = dev(np.linalg.inv(poses.astype(np.float64)))
        K = np.array([[self.f, 0, self.W / 2], [0, self.f, self.H / 2],
                      [0, 0, 1]])
        self.K = dev(np.tile(K, (m["num_views"], 1, 1)))
        self.near_far = dev([cam["near"], cam["far"]])

    def views(self, ref_view: int):
        """The reference view and its ring neighbours, nearest first."""
        out, k = [ref_view], 1
        while len(out) <= self.n_src:
            out += [(ref_view + k) % self.V, (ref_view - k) % self.V]
            k += 1
        return out[:self.n_src + 1]

    def next(self) -> dict:
        g, dev = self.g, self.g.device
        ids = self.views(int(self.rng.integers(self.V)))
        c2w = torch.stack([self.c2w[i] for i in ids])
        camrot = c2w[0, :3, :3]
        xs = torch.randint(self.W, (self.R,), generator=g, device=dev)
        ys = torch.randint(self.H, (self.R,), generator=g, device=dev)
        x = (xs.to(torch.float32) + 0.5 - self.W / 2) / self.f
        y = (ys.to(torch.float32) + 0.5 - self.H / 2) / self.f
        d = (torch.stack([x, y, torch.ones_like(x)], -1)[:, None, :]
             * camrot[None]).sum(-1)
        d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-5)
        images = torch.stack([self.imgs[i] for i in ids])
        batch = self.Batch(
            images=images, intrinsics=self.K,
            w2cs=torch.stack([self.w2c[i] for i in ids]), c2ws=c2w,
            near_far=self.near_far, campos=c2w[0, :3, 3], camrotc2w=camrot,
            raydirs=d, gt_rgb=images[0][ys, xs])
        noise = torch.randn((self.H // 4, self.W // 4), generator=g,
                            device=dev)
        jitter = torch.rand((self.R, self.D), generator=g, device=dev)
        return {"batch": batch, "noise": noise, "jitter_u": jitter}


class Joint:
    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.dev = spec, seed, device
        cfg = spec.config
        self.feed = Feed(cfg, spec.traffic["rays_per_step"], seed, device)
        self.weights = inputs.make_weights(cfg, seed, device)
        self.mvs_seed = inputs.torch_seed(seed, 5)
        self.batches = []

    def build(self):
        """The program's joint state and step, as `cmd_train_joint` builds
        them: the MVS stack from `init_joint_params` of the seed, the
        tower holding the benchmark's weights, the grid's geometry from
        the preset's ranges."""
        from pointnerf2studio_torch.ops.grid import compute_grid_geometry
        from pointnerf2studio_torch.train.joint import (
            create_joint_state, init_joint_params, make_joint_train_step)
        from perfbench.core import program
        m = self.spec.config["mvs"]
        self.pcfg = program.config(self.spec.config,
                                   self.spec.traffic["rays_per_step"])
        fields = program.aggregator(self.pcfg, self.weights, self.dev)
        mvs = init_joint_params(self.mvs_seed, num_views=m["num_views"],
                                premlp_layers=m["premlp_layers"],
                                device=self.dev)
        self.mvs_start = {k: v.detach().clone()
                          for k, v in mvs.named_parameters()}
        self.state = create_joint_state(fields, self.pcfg,
                                        num_views=m["num_views"],
                                        mvs_lr=m["mvs_lr"], mvs=mvs,
                                        device=self.dev)
        r = self.pcfg.query.ranges
        rmin, dims = compute_grid_geometry(np.asarray(r[:3]),
                                           np.asarray(r[3:]), self.pcfg.query)
        self.step_fn = make_joint_train_step(
            self.pcfg, rmin, dims, mvs_lr=m["mvs_lr"],
            num_depth=m["num_depth"], dprob_thresh=m["dprob_thresh"])

    def leaves(self) -> dict:
        st = self.state
        return {**{f"mvs.{k}": v for k, v in st.mvs.named_parameters()},
                **{f"fields.{k}": v for k, v in
                   st.fields.named_parameters()}}

    def step(self, keep: bool = False):
        b = self.feed.next()
        if keep:
            self.batches.append(b)
        return self.step_fn(self.state, b["batch"], noise=b["noise"],
                            jitter_u=b["jitter_u"])

    def first_steps(self, n: int) -> dict:
        """The first `n` steps through the window's own step and feed,
        with what the check compares: each loss, the first gradient from
        Adam's state after step 1, the change over the `n` steps, the
        first step's generated positions and each step's gate and
        in-bounds flags (the step's own calls of `generate_points_diff`,
        recorded on their way through)."""
        from pointnerf2studio_torch.train import joint
        leaves = self.leaves()
        start = {k: v.detach().clone() for k, v in leaves.items()}
        losses, grad1, xyz, valid = [], None, [], []
        gen = joint.generate_points_diff

        def recorded(*a, **k):
            out = gen(*a, **k)
            if not xyz:
                xyz.append(out["xyz"].detach().clone())
            valid.append(out["valid"].clone())
            return out

        joint.generate_points_diff = recorded
        try:
            for s in range(n):
                losses.append(self.step(keep=True)["total"])
                if s == 0:
                    grad1 = {}
                    for k, v in leaves.items():
                        opt = (self.state.opt_mvs if k.startswith("mvs.")
                               else self.state.opt_fields)
                        m = opt.state.get(v, {}).get("exp_avg")
                        grad1[k] = (torch.zeros_like(v) if m is None
                                    else m.detach() / 0.1)
        finally:
            joint.generate_points_diff = gen
        change = {k: v.detach() - start[k] for k, v in self.leaves().items()}
        return {"loss": [float(x) for x in losses], "grad1": grad1,
                "change": change, "xyz": xyz[0], "valid": valid}

    def free(self):
        self.state = self.step_fn = None
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", ring_valid=None
                  ) -> dict:
        batches = []
        for b in self.batches:
            t = b["batch"]
            batches.append({
                "images": t.images, "K": t.intrinsics, "w2c": t.w2cs,
                "c2w": t.c2ws, "campos": t.campos, "camrot": t.camrotc2w,
                "rd": t.raydirs, "gt": t.gt_rgb, "noise": b["noise"],
                "jitter_u": b["jitter_u"]})
        return ref.joint_steps(self.mvs_start, self.weights, batches,
                               self.spec.config, precision, ring_valid)


def joint_gaps(got: dict, want: dict, extent: float) -> dict:
    """The train kind's `gaps`; the first step's `xyz_gap` (the largest
    |gap| of a coordinate over `extent`); over the steps, the points whose
    flag differs off the outermost ring (`valid_mismatch`) and, read
    apart, on it (`ring_flips`: the reference's own flags there, which
    rounding decides, against `got`'s, which it took)."""
    out = gaps(got, want)
    xyz = float((got["xyz"] - want["xyz"]).abs().max()) / extent
    ring = want["ring"]
    off = sum(int(((g != w) & ~ring).sum())
              for g, w in zip(got["valid"], want["valid_own"]))
    flips = sum(int(((g != w) & ring).sum())
                for g, w in zip(got["valid"], want["valid_own"]))
    out.update(xyz_gap=xyz if np.isfinite(xyz) else float("inf"),
               valid_mismatch=float(off), ring_flips=float(flips),
               n_valid=float(want["valid"][0].sum()))
    return out


def scene_extent(cfg: dict) -> float:
    """The largest side of the configuration's `ranges` box."""
    r = cfg["query"]["ranges"]
    return float(max(hi - lo for lo, hi in zip(r[:3], r[3:])))


def costvol_device_s(prof) -> float:
    """Seconds of device operations inside the device-side ranges that
    torch.profiler mirrors for the span `joint.cost_volume` (0 where the
    program has no such span)."""
    ranges, ops = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        (ranges if e.name() == COSTVOL_SPAN else ops).append(iv)
    total = 0
    for a, b in ranges:
        pieces = sorted((max(s, a), min(e, b)) for s, e in ops
                        if s < b and e > a)
        end = a
        for s, e in pieces:
            if e > end:
                total += e - max(s, end)
                end = e
    return total * 1e-9


def run(spec, seed: int, seconds: float, trace: bool, device, t_start,
        clock=time.perf_counter, hooks=None) -> dict:
    """One run of a joint cell (see `perfbench/core/harness.py`)."""
    from perfbench.core import device as devmod, program
    tr = spec.traffic
    cell = Joint(spec, seed, device)
    cell.build()
    if hooks and "program" in hooks:
        hooks["program"](cell)
    got = cell.first_steps(tr["check_steps"])
    devmod.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    result = {"setup_s": clock() - t_start}

    def window(sec):
        t0 = clock()
        n = 0
        while clock() - t0 < sec:
            cell.step()
            n += 1
        last = float(cell.step()["total"])      # waits for the last step
        return n + 1, clock() - t0, last

    if trace:
        from torch.profiler import ProfilerActivity, profile
        before = program.launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            n, win, last = window(min(seconds, tr["trace_seconds"]))
        after = program.launches()
        result["trace"] = devmod.summarise(prof, win)
        result["trace"]["program_launches"] = {
            k: after.get(k, 0) - before.get(k, 0) for k in after}
        result["trace"]["costvol_device_s"] = costvol_device_s(prof)
        del prof
    else:
        n, win, last = window(seconds)
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    result.update(attempted=n, loop="steps", window_s=win, steps=n,
                  rays=n * tr["rays_per_step"],
                  failed=0 if np.isfinite(last) else n)
    cell.free()
    want = cell.reference(ring_valid=got["valid"])
    g = joint_gaps(got, want, scene_extent(spec.config))
    print(f"joint: median leaf's first-gradient gap "
          f"{g['grad_gap_median']!r}, change gap {g['change_gap_median']!r}, "
          f"ring flips {g['ring_flips']!r} of the first step's "
          f"{g['n_valid']!r} valid points (read, not compared)", flush=True)
    result["checks"] = {k: g[k] for k in CHECKS}
    if trace:
        cfg = spec.config
        rows = float(np.mean(want["rows"]))
        found = float(np.mean(want["found"]))
        # forward 2 operations a multiply-add, backward 4
        per_step = 3 * (mvs_counts.mvs_flops(cfg)
                        + rows * counts.row_flops(cfg["agg"])
                        + found * counts.slot_flops(cfg["agg"]))
        result["work"] = {"flops": per_step * n, "steps": n,
                          "costvol_bytes": mvs_counts.costvol_bytes(cfg) * n}
    return result


def readings(spec, seed: int, device, mode: str, frames: int = 0) -> dict:
    """The compared numbers of one seed in `mode` (`MODES`; `frames` is
    not read): the program's first steps, or in `control` the reference
    with TF32 in its convolutions and matmuls, against the reference."""
    if mode not in MODES:
        raise ValueError(f"kind 'joint' has no mode {mode!r} (has {MODES})")
    cell = Joint(spec, seed, device)
    n = spec.traffic["check_steps"]
    cell.build()
    if mode == "program":
        got = cell.first_steps(n)
        cell.free()
    else:
        cell.batches = [cell.feed.next() for _ in range(n)]
        cell.free()
        got = cell.reference("tf32")
        got["valid"] = got["valid_own"]
    return joint_gaps(got, cell.reference(ring_valid=got["valid"]),
                      scene_extent(spec.config))
