"""Traffic kind "frames": novel views rendered one after another, as a
user's evaluation or `render_video` renders them (closed loop, one
client): `train/evaluator.py::make_fast_frame_renderer` ->
`models/fast_render.py::render_frame`, each frame's colour read back to
the host.

Correctness: a sample, drawn from the seed, of the frames the window
finished (reservoir sampling), and of each a sample of its rays, against
the plain reference on the same rays (`perfbench/reference/pointnerf.py`,
the frame route): compared, the share of rays whose ray_mask differs
and, over the rays both sides hit, the mean |colour| gap; read and
printed, not compared, the mean |acc| gap and the mean relative |depth|
gap (the bf16 rounding of a seed's weights shifts every pose's density
alike, and on some seeds these read within 3x of the float8 control:
PERF.md gives the readings).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench.core import counts, inputs, scenes, spans
from perfbench.reference import pointnerf as ref

CHECKS = ("mask_mismatch", "color_mae")
FR = "pointnerf2studio_torch.models.fast_render"
# the layers a traced run names its spans by (perfbench/core/spans.py)
SPANS = ((FR, "frame_ray_order", "render_frame: slab test and sort"),
         (FR, "fast_render_rays", "render_frame: chunk"),
         (FR, "select_first_cols", "chunk: column selection"),
         (FR, "rank_gather_pack", "chunk: slot packing"),
         (FR, "_chunk_body", "chunk: selection and tower"),
         (FR, "packed_alpha_composite", "chunk: composite"))


class Frames:
    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.dev = spec, seed, device
        cfg, tr = spec.config, spec.traffic
        cam = cfg["camera"]
        self.H, self.W, self.f = cam["height"], cam["width"], cam["focal"]
        self.near, self.far = cam["near"], cam["far"]
        self.cloud = inputs.make_cloud(cfg, seed, device)
        self.weights = inputs.make_weights(cfg, seed, device)
        self.poses = inputs.make_poses(tr, seed)
        self.rays = [scenes.camera_rays(p[:3, :3], self.H, self.W, self.f)
                     for p in self.poses]
        self.render = None

    # ----------------------------------------------------------- program

    def build(self):
        """The program's frame renderer on its own cloud, grid (of the
        configuration's grid_mode) and fat cache. The frame route never
        reads the grid's legacy candidate cache, so the grid is built
        without it."""
        from pointnerf2studio_torch.ops.hash_grid import build_query_grid
        from pointnerf2studio_torch.train.evaluator import (
            make_fast_frame_renderer)
        from perfbench.core import program
        pcfg = program.config(self.spec.config)
        self.pcloud = program.cloud(self.cloud, self.dev)
        self.params = program.aggregator(pcfg, self.weights, self.dev)
        grid = build_query_grid(
            self.pcloud.xyz, self.pcloud.alive,
            dataclasses.replace(pcfg.query, use_cache=False))
        self.render = make_fast_frame_renderer(
            pcfg, self.pcloud, grid, self.near, self.far,
            chunk=self.spec.traffic["chunk"])

    def frame(self, i: int):
        """Frame i of the closed loop (pose i mod n): the program's output,
        its colour read back to the host."""
        p = self.poses[i % len(self.poses)]
        out = self.render(self.params, p[:3, 3], p[:3, :3],
                          self.rays[i % len(self.poses)])
        out.coarse_raycolor.cpu()
        return out

    def free(self):
        self.render = self.params = self.pcloud = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ window

    def run_window(self, seconds: float, clock, keep: int):
        """Frames back to back for `seconds`: (frame seconds [n], kept
        [(frame index, output)] by reservoir sampling from the seed)."""
        rng = inputs.sub_rng(self.seed, 5)
        kept, times = [], []
        t_start = clock()
        i = 0
        while True:
            t0 = clock()
            out = self.frame(i)
            t1 = clock()
            times.append(t1 - t0)
            if len(kept) < keep:
                kept.append((i, out))
            else:
                j = int(rng.integers(0, i + 1))
                if j < keep:
                    kept[j] = (i, out)
            i += 1
            if t1 - t_start >= seconds:
                return times, t1 - t_start, kept

    # ------------------------------------------------------------- check

    def reference_grid(self):
        q = self.spec.config["query"]
        return ref.build_grid(self.cloud["xyz"], q,
                              q["max_q"] or 1 << 62)

    def compare(self, kept, precision: str = "float32",
                against: str = "program") -> dict:
        """The compared numbers over `check_rays` rays of each kept frame:
        the program's answers (`against` "program") or the reference at
        `precision` (the control, "reference") against the reference in
        float32."""
        tr = self.spec.traffic
        grid = self.reference_grid()
        rng = inputs.sub_rng(self.seed, 6)
        bg = torch.tensor(self.spec.config["bg_color"], dtype=torch.float32,
                          device=self.dev)
        got, want = [], []
        for i, out in kept:
            n = len(self.poses)
            p = self.poses[i % n]
            idx = np.sort(rng.choice(self.H * self.W, tr["check_rays"],
                                     replace=False))
            rd = torch.as_tensor(self.rays[i % n][idx], device=self.dev)
            campos = torch.as_tensor(p[:3, 3], device=self.dev)
            camrot = torch.as_tensor(p[:3, :3], device=self.dev)
            kw = dict(weights=self.weights, cloud=self.cloud, grid=grid,
                      campos=campos, camrot=camrot, rd=rd, near=self.near,
                      far=self.far, cfg=self.spec.config, bg=bg)
            want.append(ref.render_rays(**kw))
            if against == "program":
                ti = torch.as_tensor(idx, device=out.ray_mask.device)
                got.append({"color": out.coarse_raycolor[ti].float(),
                            "acc": out.acc[ti].float(),
                            "depth": out.depth[ti].float(),
                            "ray_mask": out.ray_mask[ti]})
            else:
                got.append(ref.render_rays(**kw, precision=precision))
        return gaps(got, want)

    def work(self, sample: int) -> list:
        """Per pose (slots, rows, slots found) of an exact render: the
        reference's front-end and neighbour search on a seeded 1/`sample`
        of each pose's pixels, scaled up."""
        grid = self.reference_grid()
        rng = inputs.sub_rng(self.seed, 7)
        bg = torch.tensor(self.spec.config["bg_color"], dtype=torch.float32,
                          device=self.dev)
        per_pose = []
        n = self.H * self.W
        for p, rays in zip(self.poses, self.rays):
            idx = rng.choice(n, n // sample, replace=False)
            r = ref.render_rays(
                self.weights, self.cloud, grid,
                torch.as_tensor(p[:3, 3], device=self.dev),
                torch.as_tensor(p[:3, :3], device=self.dev),
                torch.as_tensor(rays[idx], device=self.dev), self.near,
                self.far, self.spec.config, bg, count_only=True)
            scale = n / len(idx)
            per_pose.append((r["n_slots"] * scale, r["n_rows"] * scale,
                             r["n_found"] * scale))
        return per_pose


def gaps(got: list, want: list) -> dict:
    """The compared numbers of answers `got` against the reference's
    `want` (lists of {color, acc, depth, ray_mask} over the same rays)."""
    keys = ("color", "acc", "depth", "ray_mask")
    g = {k: torch.cat([x[k] for x in got]) for k in keys}
    w = {k: torch.cat([x[k] for x in want]) for k in keys}
    mism = (g["ray_mask"] != w["ray_mask"]).float().mean()
    both = g["ray_mask"] & w["ray_mask"]
    if not bool(both.any()):
        return {"mask_mismatch": float(mism), "color_mae": float("inf"),
                "acc_mae": float("inf"), "depth_rel_mae": float("inf")}
    dc = (g["color"][both] - w["color"][both]).abs().mean()
    da = (g["acc"][both] - w["acc"][both]).abs().mean()
    dd = ((g["depth"][both] - w["depth"][both]).abs()
          / torch.clamp(w["depth"][both].abs(), min=1e-6)).mean()
    vals = {"mask_mismatch": mism, "color_mae": dc, "acc_mae": da,
            "depth_rel_mae": dd}
    return {k: float(v) if torch.isfinite(v) else float("inf")
            for k, v in vals.items()}


def run(spec, seed: int, seconds: float, trace: bool, device, t_start,
        clock=time.perf_counter, hooks=None) -> dict:
    """One run of a frames cell (see `perfbench/core/harness.py`)."""
    with spans.spans(SPANS if trace else ()):
        return _run(spec, seed, seconds, trace, device, t_start, clock, hooks)


def _run(spec, seed, seconds, trace, device, t_start, clock, hooks):
    from perfbench.core import device as devmod, program
    tr = spec.traffic
    cell = Frames(spec, seed, device)
    cell.build()
    if hooks and "program" in hooks:
        hooks["program"](cell)
    for i in range(tr["warmup_frames"]):
        cell.frame(i)
    devmod.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock() - t_start
    result = {"setup_s": setup_s}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        before = program.launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            times, window, kept = cell.run_window(
                min(seconds, tr["trace_seconds"]), clock, tr["check_frames"])
            devmod.sync(device)
        after = program.launches()
        result["trace"] = devmod.summarise(prof, window)
        result["trace"]["program_launches"] = {
            k: after.get(k, 0) - before.get(k, 0) for k in after}
        del prof
    else:
        times, window, kept = cell.run_window(seconds, clock,
                                              tr["check_frames"])
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    n = len(times)
    result.update(attempted=n, window_s=window, frame_s=times,
                  frames=n, pixels=cell.H * cell.W)
    cell.free()
    result["failed"] = sum(1 for _, o in kept
                           if not bool(torch.isfinite(o.coarse_raycolor).all()))
    g = cell.compare(kept)
    print(f"frames: acc gap {g['acc_mae']!r}, relative depth gap "
          f"{g['depth_rel_mae']!r} (read, not compared)", flush=True)
    result["checks"] = {k: g[k] for k in CHECKS}
    if trace:
        per_pose = cell.work(tr["count_sample"])
        npose = len(cell.poses)
        work = [per_pose[i % npose] for i in range(n)]
        agg = spec.config["agg"]
        flops = bytes_ = d2_flops = d2_bytes = 0.0
        for slots, rows, found in work:
            f, b = counts.render_work(agg, spec.config["query"]["cand_cap"],
                                      slots, rows, found)
            flops, bytes_ = flops + f, bytes_ + b
            f, b = counts.decode2_work(agg, rows, found)
            d2_flops, d2_bytes = d2_flops + f, d2_bytes + b
        result["work"] = {"flops": flops, "bytes": bytes_, "frames": n,
                          "decode2": (d2_flops, d2_bytes)}
    return result
