"""Traffic kind "train": `fit()`'s default step, one after another, on
batches that the benchmark's copy of the device sampler draws:
`train/trainer.py::make_train_step` (the legacy `render_rays(training=
True)` on the grid and its candidate cache, the losses, the backward and
both Adam groups).

Set-up builds one train state and drives it through the window's own
step and feed for `check_steps` steps; the window goes on with that same
state. Correctness: the reference follows those first steps from the same
weights, cloud, batches and jitter draws. Compared: each step's loss (the
largest relative gap), the first gradient as the optimizer got it (worked
out from Adam's first moment after one step) and the parameters' change
over the steps, each by the worst leaf (the gap between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and the median leaf's). Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone under Adam and
are left out of the change. The medians over the leaves of each leaf's
gradient and change gaps are read and printed, not compared (PERF.md
gives the readings).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.core import counts, inputs, spans
from perfbench.reference import pointnerf as ref

# the compared numbers (limits and readings: PERF.md); the medians over
# the leaves are read and printed, not compared
CHECKS = ("loss_gap", "grad_gap", "change_gap")
# the layers a traced run names its spans by (perfbench/core/spans.py);
# installed before the step is made, which binds the first two
SPANS = (("pointnerf2studio_torch.models.render", "render_rays",
          "step: forward render"),
         ("pointnerf2studio_torch.train.loss", "compute_losses",
          "step: losses"),
         ("pointnerf2studio_torch.train.trainer", "apply_updates",
          "step: optimizer"))
NEGLIGIBLE_GRAD = 1e-3
# tools/readings.py's modes: the program (with PyTorch's TF32 matmuls on
# in program_tf32, its own path one precision below a float32 tower), the
# control, and the reference on half of each batch (the mean taken over
# the rest) in the program's place
MODES = ("program", "control", "program_tf32", "half_batch")
# the CPU tests' tiny traffic (perfbench/tests/tiny.py)
TINY_TRAFFIC = {"rays_per_step": 128, "trace_seconds": 1.0}


class Train:
    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.dev = spec, seed, device
        cfg, tr = spec.config, spec.traffic
        self.near, self.far = cfg["camera"]["near"], cfg["camera"]["far"]
        self.cloud = inputs.make_cloud(cfg, seed, device)
        self.weights = inputs.make_weights(cfg, seed, device)
        imgs, poses = inputs.make_views(cfg, tr, seed, device)
        self.sampler = inputs.Sampler(imgs, poses, cfg["camera"]["focal"],
                                      tr["rays_per_step"],
                                      cfg["query"]["z_depth_dim"], seed)
        self.batches = []

    def build(self):
        """The program's train state, step, grid with its candidate cache
        and device planes."""
        from pointnerf2studio_torch.ops.hash_grid import build_query_grid
        from pointnerf2studio_torch.train.trainer import (
            create_train_state, make_train_step)
        from perfbench.core import program
        self.pcfg = program.config(self.spec.config,
                                   self.spec.traffic["rays_per_step"])
        pcloud = program.cloud(self.cloud, self.dev)
        params = program.aggregator(self.pcfg, self.weights, self.dev)
        self.grid = build_query_grid(pcloud.xyz, pcloud.alive,
                                     self.pcfg.query)
        self.state = create_train_state(params, pcloud, self.pcfg)
        self.step_fn = make_train_step(self.pcfg)
        self.near_t = torch.tensor(self.near, device=self.dev)
        self.far_t = torch.tensor(self.far, device=self.dev)

    def leaves(self) -> dict:
        st = self.state
        out = {}
        for name in ref.TOWERS:
            for i, lin in enumerate(getattr(st.params, name)):
                out[f"{name}.{i}.weight"] = lin.weight
                out[f"{name}.{i}.bias"] = lin.bias
        for k, v in (("emb", st.points.points_embeding),
                     ("conf", st.points.points_conf),
                     ("dir", st.points.points_dir),
                     ("color", st.points.points_color)):
            out[f"points.{k}"] = v
        return out

    def step(self, keep: bool = False):
        b = self.sampler.next()
        if keep:
            self.batches.append(b)
        self.state, aux = self.step_fn(self.state, self.grid, b[0], b[1],
                                       b[2], b[3], self.near_t, self.far_t,
                                       jitter_u=b[4])
        return aux

    def first_steps(self, n: int) -> dict:
        """The first `n` steps through the window's own step and feed,
        with what the check compares: each loss, the first gradient from
        Adam's state after step 1, the change over the `n` steps."""
        leaves = self.leaves()
        start = {k: v.detach().clone() for k, v in leaves.items()}
        losses, grad1 = [], None
        for s in range(n):
            aux = self.step(keep=True)
            losses.append(aux["total"])
            if s == 0:
                grad1 = {}
                for k, v in leaves.items():
                    opt = (self.state.opt_points if k.startswith("points.")
                           else self.state.opt_fields)
                    st = opt.state.get(v, {})
                    m = st.get("exp_avg")
                    grad1[k] = (torch.zeros_like(v) if m is None
                                else m.detach() / 0.1)
        change = {k: v.detach() - start[k] for k, v in self.leaves().items()}
        return {"loss": [float(x) for x in losses], "grad1": grad1,
                "change": change}

    def free(self):
        self.state = self.step_fn = self.grid = None
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> dict:
        grid = ref.build_grid(self.cloud["xyz"], self.spec.config["query"],
                              self.spec.config["query"]["max_q"]
                              or 4 * self.spec.config["query"]["max_o"])
        return ref.train_steps(self.weights, self.cloud, grid, self.batches,
                               self.near, self.far, self.spec.config,
                               precision)


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            d.items()}


def gaps(got: dict, want: dict) -> dict:
    """The numbers of `got` against the reference `want` (each {"loss",
    "grad1", "change"}): the losses' largest relative gap; the worst
    leaf's gap of first-gradient norms and of change norms; and the
    median, over the leaves, of each leaf's gap (steady from seed to
    seed, where the worst leaf swings)."""
    lg = max(abs(a - b) / max(abs(b), 1e-12)
             for a, b in zip(got["loss"], want["loss"]))
    gw, gg = _norms(want["grad1"]), _norms(got["grad1"])
    med_g = float(np.median(list(gw.values())))
    per_g = [abs(gg[k] - gw[k]) / max(gw[k], med_g, 1e-30) for k in gw]
    moving = [k for k in gw if gw[k] >= NEGLIGIBLE_GRAD * med_g]
    cw, cg = _norms(want["change"]), _norms(got["change"])
    med_c = float(np.median([cw[k] for k in moving]))
    per_c = [abs(cg[k] - cw[k]) / max(cw[k], med_c, 1e-30) for k in moving]
    out = {"loss_gap": lg, "grad_gap": max(per_g),
           "change_gap": max(per_c),
           "grad_gap_median": float(np.median(per_g)),
           "change_gap_median": float(np.median(per_c))}
    return {k: v if np.isfinite(v) else float("inf") for k, v in out.items()}


def run(spec, seed: int, seconds: float, trace: bool, device, t_start,
        clock=time.perf_counter, hooks=None) -> dict:
    """One run of a train cell (see `perfbench/core/harness.py`)."""
    with spans.spans(SPANS if trace else ()):
        return _run(spec, seed, seconds, trace, device, t_start, clock, hooks)


def _run(spec, seed, seconds, trace, device, t_start, clock, hooks):
    from perfbench.core import device as devmod, program
    tr = spec.traffic
    cell = Train(spec, seed, device)
    cell.build()
    if hooks and "program" in hooks:
        hooks["program"](cell)
    got = cell.first_steps(tr["check_steps"])
    devmod.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock() - t_start
    result = {"setup_s": setup_s}

    def window(sec):
        t0 = clock()
        n = 0
        while clock() - t0 < sec:
            cell.step()
            n += 1
        aux = cell.step()
        n += 1
        last = float(aux["total"])       # waits for the last step
        return n, clock() - t0, last

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
        del prof
    else:
        n, win, last = window(seconds)
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    result.update(attempted=n, loop="steps", window_s=win, steps=n,
                  rays=n * tr["rays_per_step"],
                  failed=0 if np.isfinite(last) else n)
    cell.free()
    want = cell.reference()
    g = gaps(got, want)
    print(f"train: median leaf's first-gradient gap "
          f"{g['grad_gap_median']!r}, change gap {g['change_gap_median']!r} "
          f"(read, not compared)", flush=True)
    result["checks"] = {k: g[k] for k in CHECKS}
    if trace:
        rows = float(np.mean(want["rows"]))
        found = float(np.mean(want["found"]))
        agg = spec.config["agg"]
        # forward 2 operations a multiply-add, backward 4
        per_step = 3 * (rows * counts.row_flops(agg)
                        + found * counts.slot_flops(agg))
        result["work"] = {"flops": per_step * n, "steps": n}
    return result


def readings(spec, seed: int, device, mode: str, frames: int = 0) -> dict:
    """The compared numbers of one seed in `mode` (`MODES`; `frames` is
    not read): the program's first steps, or in `control` and
    `half_batch` the reference so changed, against the reference."""
    if mode not in MODES:
        raise ValueError(f"kind 'train' has no mode {mode!r} (has {MODES})")
    cell = Train(spec, seed, device)
    n = spec.traffic["check_steps"]
    if mode in ("program", "program_tf32"):
        tf32 = mode == "program_tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        cell.build()
        prog = cell.first_steps(n)
        cell.free()
        torch.backends.cuda.matmul.allow_tf32 = False
        return gaps(prog, cell.reference())
    cell.batches = [cell.sampler.next() for _ in range(n)]
    want = cell.reference()
    if mode == "control":
        other = cell.reference(ref.control_precision(spec.config["agg"]))
    else:
        full = cell.batches
        half = cell.spec.traffic["rays_per_step"] // 2
        cell.batches = [tuple(x[:half] if x.dim() and x.shape[0]
                              == 2 * half else x for x in b)
                        for b in full]
        other = cell.reference()
    return gaps(other, want)
