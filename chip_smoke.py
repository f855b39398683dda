#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pointnerf2studio_torch/csrc/` (four
sources, the tower header and the selection header two of them share
each) with nvcc (sm_90a), builds the 558k-point procedural chair scene,
its voxel grid and its candidate cache (metas, candidate-major payload,
xyz planes) on the GPU, and drives three
paths at the full width of the chair model (focal 1111.1, 400 samples
per ray, K = 8, bf16 aggregator of hidden 256 / colour 128, random
weights from seed 0), in 65,536-ray chunks, with the depth window and
ray budget measured on the frame as the JAX bench sizes them:

  1. the whole 800x800 frame through `fast_render_rays` with
     chunk_mode="fused" (kernels first_valid_cols, fused_chunk_decode);
  2. the whole frame through the staged fast path, knn_mode="fused" and
     fused_decode2 on (kernels first_valid_cols, fused_candidate_select,
     fused_decode2), held to frame 1: ray_mask equal, colour within
     2e-2, mean < 2e-3;
  3. one 65,536-ray chunk of the frame through the legacy `render_rays`
     on the point cloud and grid, fused_decode on (kernels
     first_valid_cols at BP = 80 / D = 400, fused_decode); its agreement
     with the fast path on those rays is printed, not asserted.

The launch counts are set to 0 just before each path and read just
after it. It fails (non-zero exit, no result line) when there is no
CUDA device, when a kernel does not build or launch, when a kernel of a
path was not launched on it, when an exactness counter is non-zero,
when miss rays are not exactly background, when a kernel disagrees with
its plain PyTorch version on inputs captured from its path's first
chunk (first_valid_cols and fused_candidate_select: exactly;
fused_chunk_decode: `found` exactly, rgb within 2e-2, sigma within
2e-2 + 2^-7 |sigma|, mean |diff| < 2e-3; fused_decode and
fused_decode2: aw within 2e-2 + 2^-7 |aw|, hw within 1e-3 + 2^-7 |hw|
with mean |diff| of hw <= 2^-8 mean |hw|, mean over both < 2e-3), or when a path's first chunk rendered through the kernels
differs from the same chunk rendered through the plain versions
(ray_mask exactly, colour within the same bound). Printed before the
last line: the card's name and power limit, build and phase times, each
kernel's and its plain version's time at its path's shapes beside the
least time the card could take (bytes over 3.35 TB/s or operations over
989 TFLOP/s bf16, whichever is larger), the ratio of the two and, for
the three tower kernels, the TFLOP/s of useful work, each path's rays/s,
and one JSON line of kernel records. first_valid_cols is timed twice: on
one qs buffer, which the 50 MB L2 holds from launch to launch, and
rotating over copies of qs that exceed the L2 together; the second is
its "ms", the time its bound of device-memory bytes speaks of. Both are
taken with the launches queued behind a busy device: the kernel runs
shorter than its wrapper takes on the host, so launches timed one by one
read the host's call rate ("host_paced_ms", printed beside them). The
last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile[=DIR]

also runs one warm pass of each path under torch.profiler after its
timing and prints, per path, the device time by kernel name (the ten
largest), their sum and the device's idle share of the unprofiled pass
(1 - device time / pass time); the full tables go to
`DIR/profile_<path>.txt` (DIR defaults to `build/profile`).

    python3 chip_smoke.py --probe

also builds `csrc/fused_decode.cu` and `csrc/fused_chunk.cu` with parts
of the kernels left out (`TOWER_PROBE` in `csrc/tower.cuh`) and prints
fused_decode2's and fused_chunk_decode's time with each build on their
paths' inputs: what each part costs.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

H = W = 800
FOCAL = 1111.1
N_POINTS = 558_000
CHUNK = 65_536
ATOL, MEAN_TOL = 2e-2, 2e-3
# sigma is a K-sum of alpha_k * w_k with each alpha_k a bf16-rounded
# ReLU output, so one rounding flip moves it by ulp(alpha_k) * w_k <=
# 2^-7 alpha_k w_k; at the scene's densities (~5) that alone exceeds ATOL
SIG_RTOL = 2.0 ** -7
# hw (h * wk per row, or its K-sum) is small beside ATOL (mean |hw| 0.003
# to 0.015 on the chair frame), so it is held relative to its size: one
# bf16 ulp of the plain value over a floor for values near 0, where a
# flipped bf16 rounding of an earlier layer still moves h by some 1e-4;
# its mean |diff| is held to a fraction of mean |hw|
HW_RTOL, HW_ATOL, HW_MEAN_RTOL = 2.0 ** -7, 1e-3, 2.0 ** -8
# the card's published peaks (H100 SXM): device memory bytes/s and dense
# bf16 tensor-core FLOP/s
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12
# multiply-adds per (slot, neighbour) row of the per-neighbour tower and
# per slot of the colour tower (hidden 256, colour 128, 3 colour layers)
ROW_MACS = 284 * 256 + 256 * 256 + 263 * 256 + 256 * 256 + 256
SLOT_MACS = 280 * 128 + 128 * 128 + 128 * 128 + 128 * 3


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def bench_config():
    """The JAX bench's chair QueryConfig (bench.py:88-105) on the fused
    path: select_mode="pallas" and chunk_mode="fused"."""
    from pointnerf2studio_torch.config import (
        AggregatorConfig, PointNerfConfig, QueryConfig)
    return PointNerfConfig(
        query=QueryConfig(
            vsize=(0.004, 0.004, 0.004), vscale=(2, 2, 2), SR=80, K=8, P=12,
            max_o=700_000, z_depth_dim=400, compact_budget=8,
            ray_slot_budget=32, use_cache=False, fast_chunk=4096,
            select_mode="pallas", chunk_mode="fused"),
        agg=AggregatorConfig(compute_dtype="bfloat16", pe_mode="rec"))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float):
    """(least ms the card could take, what bounds it)."""
    t_b, t_f = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def fused_chunk_weight_bytes(agg) -> int:
    """bf16 bytes of every weight and bias the fused chunk kernel reads."""
    return 2 * sum(p.numel() for p in agg.parameters())


def cuda_ms(fn, iters: int, warmup: int = 1, queued: bool = False) -> float:
    """ms per call of `fn` by CUDA events around `iters` calls. A kernel
    that runs shorter than its wrapper takes on the host (tens of
    microseconds of Python) is paced by the host, and the events then read
    the host's call rate. `queued` keeps the device busy first
    (torch.cuda._sleep, some 10 ms) while the host enqueues every call, so
    the calls run back to back and the events read device time."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating_ms(fn, tensor, iters: int = 48, shift: int = 0) -> float:
    """Device ms of `fn(copy)` over copies of `tensor` taken in turn,
    enough of them (at least 4 x 50 MB) that no launch finds its input in
    the L2; the launches are queued behind a busy device (`cuda_ms`).
    `shift` starts each copy that many elements into its buffer (1: int32
    rows off the 16-byte boundaries)."""
    n = max(2, -(-4 * 50_000_000 // max(nbytes(tensor), 1)))
    copies = []
    for _ in range(n):
        buf = tensor.new_empty(tensor.numel() + shift)
        copies.append(buf[shift:].view(tensor.shape).copy_(tensor))
    turn = iter(range(1 << 30))
    return cuda_ms(lambda: fn(copies[next(turn) % n]), iters, n, queued=True)


def device_rows(fn, iters: int = 1):
    """[(device ms, launches, kernel name)], largest first, of `iters`
    warm calls of `fn` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)


def profile_pass(name: str, fn, pass_ms: float, out: pathlib.Path) -> None:
    """One warm pass of `fn` under torch.profiler: device time by kernel
    name, and the idle share of the unprofiled pass of `pass_ms`."""
    rows = device_rows(fn)
    total = sum(r[0] for r in rows)
    if total <= 0:
        fail(f"profile of {name}: the profiler saw no device time")
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{name}.txt").write_text("".join(
        f"{ms:10.3f} ms {n:6d} x {key}\n" for ms, n, key in rows))
    log(f"profile {name}: device time {total:.1f} ms in {len(rows)} kernel "
        f"names, {sum(r[1] for r in rows)} launches; unprofiled pass "
        f"{pass_ms:.1f} ms, idle share {1 - total / pass_ms:.3f}")
    for ms, n, key in rows[:10]:
        log(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% {n:5d} x {key[:90]}")


def device_kernel_ms(fn, names, iters: int = 3) -> dict:
    """Device ms a launch of the kernel whose name holds each of `names`,
    over `iters` calls of `fn` under torch.profiler."""
    rows = device_rows(fn, iters)
    out = {n: ms / count for ms, count, key in rows for n in names
           if n in key and count}
    missing = [n for n in names if out.get(n, 0) <= 0]
    if missing:
        fail(f"the profiler saw no device time for {missing}")
    return out


PROBES = {0: "whole kernel", 1: "no feature rows", 2: "no wgmma",
          4: "no weight copies", 8: "no K-sums", 16: "no colour tower",
          6: "no wgmma, no copies",
          15: "tile forming and layer epilogues only",
          23: "selection, tile forming, layer epilogues and K-sums only"}


def probe_tower(source: str, bits_list, name: str, fn) -> None:
    """--probe: csrc/<source>.cu built with parts of the tower left out
    (the TOWER_PROBE bits of csrc/tower.cuh) and `fn`, the kernel's
    wrapper on the main path's inputs, timed with each build. The outputs
    of a probe build are wrong on purpose; only its time is read."""
    from pointnerf2studio_torch.ops import _cuda
    flags = {bits: [f"-DTOWER_PROBE={bits}"] for bits in bits_list}
    _cuda.build([(source, f) for f in flags.values()])
    for bits, f in flags.items():
        with _cuda.variant(source, f):
            t = cuda_ms(fn, 10, 2)
        log(f"probe {name}, TOWER_PROBE={bits} ({PROBES[bits]}): {t:.3f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pointnerf2studio_torch.data.synthetic import (
        camera_rays, make_chair_scene)
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import fused_decode as fd
    from pointnerf2studio_torch.ops import fused_select as fs
    from pointnerf2studio_torch.ops.fused_chunk import (
        fused_chunk_decode, fused_chunk_decode_plain)
    from pointnerf2studio_torch.ops.select import (
        first_valid_cols, first_valid_cols_reference)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _cuda.build()
    log(f"built {sorted(libs)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- scene, grid, cache
    cfg = bench_config()
    t0 = time.perf_counter()
    scene = make_chair_scene(N_POINTS, seed=0, cfg=cfg, device=dev)
    grid = scene.grid
    raydirs_frame = camera_rays(scene.camrotc2w, H, W, FOCAL)
    total = raydirs_frame.shape[0]
    perm = np.random.default_rng(0).permutation(total)
    raydirs = raydirs_frame[torch.as_tensor(perm, device=dev)]
    n_chunks = -(-total // CHUNK)
    q = cfg.query
    dw = fr.measured_depth_window(scene.campos, raydirs, scene.near,
                                  scene.far, q.z_depth_dim, grid.ranges_min,
                                  grid.dims, q.scaled_vsize)
    hits = fr.slab_hit_mask(scene.campos, raydirs, scene.near, scene.far,
                            q.z_depth_dim, grid.ranges_min, grid.dims,
                            q.scaled_vsize)
    per_chunk = max(int(hits[i * CHUNK:(i + 1) * CHUNK].sum())
                    for i in range(n_chunks))
    rb = min(CHUNK, (per_chunk + W + 1023) // 1024 * 1024)
    cfg = dataclasses.replace(cfg, query=dataclasses.replace(
        q, depth_window=dw, ray_budget=rb))
    cache, rmin, svs = fr.make_fast_scene(cfg, scene.cloud, grid)
    torch.cuda.synchronize()
    log(f"scene: {N_POINTS} points, grid {grid.dims}, n_occ "
        f"{int(grid.n_occ)}, n_q {int(cache.n_q)}, max_q "
        f"{cache.kmeta.shape[0]}, C {cache.cand}; depth_window {dw}, "
        f"ray_budget {rb}, hit rays {int(hits.sum())} of {total}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    if (cache.kpay.data_ptr() != cache.kcand.data_ptr()
            or not cache.kcand.is_contiguous()):
        fail("the cache's kpay is not a view of the candidate-major kcand")
    log(f"cache: kmeta {nbytes(cache.kmeta)} B, kcand "
        f"{tuple(cache.kcand.shape)} {nbytes(cache.kcand)} B (kpay is its "
        f"[max_q, PK, C] view), kxyz {tuple(cache.kxyz.shape)} "
        f"{nbytes(cache.kxyz)} B, coor_2_qslot {nbytes(cache.coor_2_qslot)} "
        f"B; device memory allocated {torch.cuda.memory_allocated()} B")

    def render(rays, c=cfg):
        return fr.fast_render_rays(
            scene.params, scene.cloud.Rw2c, cache, scene.campos,
            scene.camrotc2w, rays, scene.near, scene.far, c, rmin, svs)

    def render_frame(c=cfg):
        return [render(raydirs[i * CHUNK:(i + 1) * CHUNK], c)
                for i in range(n_chunks)]

    # capture the kernels' inputs from chunk 0 of the main-path run
    captured = {}
    orig_select, orig_fused = fr.select_first_cols, fr.fused_chunk_decode

    def capture_select(qs, BP, cap, mode):
        captured.setdefault("select", (qs, BP))
        return orig_select(qs, BP, cap, mode)

    def capture_fused(*args, **kw):
        captured.setdefault("fused", (args, kw))
        return orig_fused(*args, **kw)

    # ---- the main path: the whole frame, launches counted
    fr.select_first_cols, fr.fused_chunk_decode = capture_select, capture_fused
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    outs = render_frame()
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    fr.select_first_cols, fr.fused_chunk_decode = orig_select, orig_fused
    log(f"frame rendered (first pass) in {time.perf_counter() - t0:.2f} s; "
        f"launches {launches}")
    for name in ("first_valid_cols", "fused_chunk_decode"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")

    # ---- exactness counters and the frame's output
    ctr = {f: [int(getattr(o, f)) for o in outs]
           for f in ("dw_overflow", "rb_overflow", "cb_overflow")}
    log(f"counters per chunk: {ctr}")
    if any(v for vals in ctr.values() for v in vals):
        fail(f"non-zero exactness counter: {ctr}")
    color = torch.cat([o.coarse_raycolor for o in outs])
    mask = torch.cat([o.ray_mask for o in outs])
    acc = torch.cat([o.acc for o in outs])
    nvs = sum(int(o.n_valid_slots) for o in outs)
    frame = torch.empty_like(color)
    frame[torch.as_tensor(perm, device=dev)] = color
    bg = torch.tensor(cfg.bg_color, device=dev)
    if frame.shape != (total, 3) or not torch.isfinite(frame).all():
        fail("frame colour is not finite or has the wrong shape")
    if not torch.equal(color[~mask], bg.expand(int((~mask).sum()), 3)):
        fail("miss rays are not exactly background")
    hit_frac = float(mask.float().mean())
    if not 0.05 < hit_frac < 0.95 or float(acc[mask].mean()) <= 0.0:
        fail(f"implausible frame: ray_mask fraction {hit_frac:.3f}")
    log(f"frame: ray_mask fraction {hit_frac:.4f}, mean acc on hits "
        f"{float(acc[mask].mean()):.4f}, valid slots {nvs} "
        f"({nvs / total:.3f} per ray)")

    # ---- each kernel against its plain version on chunk 0's inputs
    qs, BP = captured["select"]
    cs_k, cn_k = first_valid_cols(qs, BP)
    cs_p, cn_p = first_valid_cols_reference(qs, BP)
    sel_err = int((cs_k - cs_p).abs().max()) + int((cn_k - cn_p).abs().max())
    if not (torch.equal(cs_k, cs_p) and torch.equal(cn_k, cn_p)):
        fail(f"first_valid_cols differs from its plain version "
             f"(max |diff| {sel_err})")
    log(f"first_valid_cols == plain on qs {tuple(qs.shape)}")

    args, kw = captured["fused"]
    sig_k, rgb_k, fnd_k = fused_chunk_decode(*args, **kw)
    sig_p, rgb_p, fnd_p = fused_chunk_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(fnd_k, fnd_p):
        fail(f"fused_chunk_decode found differs on "
             f"{int((fnd_k != fnd_p).sum())} slots")
    m_sl = args[-1]
    d_sig = (sig_k - sig_p).abs()[m_sl]
    d_rgb = (rgb_k - rgb_p).abs()[m_sl]
    fused_err = float(max(d_sig.max(), d_rgb.max()))
    fused_mean = float(torch.cat([d_sig, d_rgb.reshape(-1)]).mean())
    sig_ok = bool((d_sig <= ATOL + SIG_RTOL * sig_p.abs()[m_sl]).all())
    log(f"fused_chunk_decode vs plain on M={m_sl.shape[0]} slots "
        f"({int(m_sl.sum())} valid, {int(fnd_k.sum())} found, mean sigma "
        f"{float(sig_k[m_sl].mean()):.4f}): found equal, max |diff| "
        f"sigma {float(d_sig.max()):.3e} rgb {float(d_rgb.max()):.3e}, "
        f"mean {fused_mean:.3e}")
    if not (sig_ok and float(d_rgb.max()) <= ATOL
            and fused_mean < MEAN_TOL):
        fail("fused_chunk_decode disagrees with its plain version")

    # ---- the whole chunk through the kernels vs the plain versions
    rays0 = raydirs[:CHUNK]
    out_k = render(rays0)
    fr.fused_chunk_decode = fused_chunk_decode_plain
    try:
        out_p = render(rays0, dataclasses.replace(
            cfg, query=dataclasses.replace(cfg.query, select_mode="topk")))
    finally:
        fr.fused_chunk_decode = orig_fused
    if not torch.equal(out_k.ray_mask, out_p.ray_mask):
        fail("chunk ray_mask differs between kernels and plain versions")
    dc = (out_k.coarse_raycolor - out_p.coarse_raycolor).abs()
    log(f"chunk 0 kernels vs plain: ray_mask equal, colour max |diff| "
        f"{float(dc.max()):.3e}, mean {float(dc.mean()):.3e}")
    if not (float(dc.max()) <= ATOL and float(dc.mean()) < MEAN_TOL):
        fail("chunk colour through the kernels disagrees with plain")

    # ---- times at the main path's shapes (CUDA events)
    t_sel_host = cuda_ms(lambda: first_valid_cols(qs, BP), 50, 3)
    t_sel_l2 = cuda_ms(lambda: first_valid_cols(qs, BP), 48, 3, queued=True)
    t_sel_k = rotating_ms(lambda x: first_valid_cols(x, BP), qs)
    # rows off the 16-byte boundaries take the scalar kernel: 32-column
    # tiles, a ballot after each load, direct 4-byte stores
    t_sel_sc = rotating_ms(lambda x: first_valid_cols(x, BP), qs, shift=1)
    t_sel_p = cuda_ms(lambda: first_valid_cols_reference(qs, BP), 20, 2)
    t_fc_k = cuda_ms(lambda: fused_chunk_decode(*args, **kw), 10, 2)
    t_fc_p = cuda_ms(lambda: fused_chunk_decode_plain(*args, **kw), 2, 1)
    log(f"first_valid_cols qs {tuple(qs.shape)}: kernel {t_sel_k:.4f} ms, "
        f"plain {t_sel_p:.4f} ms")
    fc_parts = ["chunk_select_kernel", "chunk_tower_kernel",
                "chunk_colour_kernel"]
    t_fc_parts = device_kernel_ms(lambda: fused_chunk_decode(*args, **kw),
                                  fc_parts)
    log(f"fused_chunk_decode M={m_sl.shape[0]}: kernel {t_fc_k:.3f} ms "
        f"(its device kernels by the profiler: "
        + ", ".join(f"{n} {t_fc_parts[n]:.3f}" for n in fc_parts)
        + f"), plain {t_fc_p:.3f} ms")

    frame_ms = [cuda_ms(render_frame, 1) for _ in range(3)]
    best = min(frame_ms)
    log(f"full frame {total} rays: {[round(t, 2) for t in frame_ms]} ms -> "
        f"{total / best * 1e3:.1f} rays/s (best of 3; {smi})")
    prof_arg = next((a for a in sys.argv[1:] if a.startswith("--profile")),
                    None)
    prof_dir = pathlib.Path(
        prof_arg.partition("=")[2] or "build/profile") if prof_arg else None
    if prof_dir:
        profile_pass("fused_chunk", render_frame, best, prof_dir)

    # =================================================================
    # Path A: the staged fast path (select kernel + decode tail +
    # K-accumulating decode kernel) over the whole frame
    # =================================================================
    cfg_a = dataclasses.replace(
        cfg, query=dataclasses.replace(cfg.query, knn_mode="fused",
                                       chunk_mode="xla"),
        agg=dataclasses.replace(cfg.agg, fused_decode2=True))
    orig_fsel, orig_kacc = fr.fused_candidate_select, fd.kacc_tower

    def capture_fsel(*a):
        captured.setdefault("fsel", a)
        return orig_fsel(*a)

    def capture_kacc(*a, **k):
        captured.setdefault("kacc", (a, k))
        return orig_kacc(*a, **k)

    fr.fused_candidate_select, fd.kacc_tower = capture_fsel, capture_kacc
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    outs_a = render_frame(cfg_a)
    torch.cuda.synchronize()
    launches_a = dict(_cuda.LAUNCHES)
    fr.fused_candidate_select, fd.kacc_tower = orig_fsel, orig_kacc
    log(f"path A frame rendered (first pass) in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches_a}")
    for name in ("first_valid_cols", "fused_candidate_select",
                 "fused_decode2"):
        if launches_a.get(name, 0) != n_chunks:
            fail(f"path A: kernel {name} launched "
                 f"{launches_a.get(name, 0)} times on {n_chunks} chunks")
    ctr_a = {f: [int(getattr(o, f)) for o in outs_a]
             for f in ("dw_overflow", "rb_overflow", "cb_overflow")}
    if any(v for vals in ctr_a.values() for v in vals):
        fail(f"path A: non-zero exactness counter: {ctr_a}")
    color_a = torch.cat([o.coarse_raycolor for o in outs_a])
    mask_a = torch.cat([o.ray_mask for o in outs_a])
    if color_a.shape != (total, 3) or not torch.isfinite(color_a).all():
        fail("path A: frame colour is not finite or has the wrong shape")
    if not torch.equal(color_a[~mask_a],
                       bg.expand(int((~mask_a).sum()), 3)):
        fail("path A: miss rays are not exactly background")
    if not torch.equal(mask_a, mask):
        fail(f"path A: ray_mask differs from the fused-chunk frame on "
             f"{int((mask_a != mask).sum())} rays")
    d_a = (color_a - color).abs()
    log(f"path A frame vs fused-chunk frame: counters zero, ray_mask "
        f"equal, colour max |diff| {float(d_a.max()):.3e}, mean "
        f"{float(d_a.mean()):.3e}")
    if not (float(d_a.max()) <= ATOL and float(d_a.mean()) < MEAN_TOL):
        fail("path A: frame colour disagrees with the fused-chunk frame")

    # ---- fused_candidate_select vs plain on chunk 0's inputs (exact)
    fsel_args = captured["fsel"]
    ns_k, pm_k = fs.fused_candidate_select(*fsel_args)
    ns_p, pm_p = fs.fused_candidate_select_plain(*fsel_args)
    torch.cuda.synchronize()
    fsel_bits = int((ns_k.view(torch.int16) != ns_p.view(torch.int16)).sum())
    if not torch.equal(pm_k, pm_p) or fsel_bits:
        fail(f"fused_candidate_select differs from its plain version: "
             f"pnt_mask on {int((pm_k != pm_p).sum())} entries, payload "
             f"on {fsel_bits}")
    fsel_err = float((ns_k.float() - ns_p.float()).abs().max())
    m_a = fsel_args[5]
    n_pairs = int(pm_k.sum())
    log(f"fused_candidate_select == plain on M={m_a.shape[0]} slots "
        f"({int(m_a.sum())} valid, {n_pairs} neighbours, "
        f"{n_pairs / max(int(m_a.sum()), 1):.2f} per valid slot): "
        f"pnt_mask and payload bits equal")

    def tower_check(name, kern, plain, a, k):
        aw_k, hw_k = kern(*a, **k)
        aw_p, hw_p = plain(*a, **k)
        torch.cuda.synchronize()
        d_aw = (aw_k - aw_p).abs()
        hw_abs = hw_p.float().abs()
        d_hw = (hw_k.float() - hw_p.float()).abs()
        mean = float(torch.cat([d_aw.reshape(-1), d_hw.reshape(-1)]).mean())
        hw_mean, hw_scale = float(d_hw.mean()), float(hw_abs.mean())
        hw_worst = float((d_hw / (HW_ATOL + HW_RTOL * hw_abs)).max())
        log(f"{name} vs plain on emb {tuple(a[1].shape)} "
            f"({int((a[5] != 0).sum())} rows with a weight): max |diff| "
            f"aw {float(d_aw.max()):.3e} hw {float(d_hw.max()):.3e}, "
            f"mean {mean:.3e}; plain mean aw {float(aw_p.mean()):.4f}, "
            f"mean |hw| {hw_scale:.4f}; hw: largest |diff| / (1e-3 + 2^-7 "
            f"|hw|) {hw_worst:.3f}, mean |diff| / mean |hw| "
            f"{hw_mean / hw_scale:.3e}")
        if not (bool((d_aw <= ATOL + SIG_RTOL * aw_p.abs()).all())
                and hw_worst <= 1.0 and hw_mean <= HW_MEAN_RTOL * hw_scale
                and mean < MEAN_TOL):
            fail(f"{name} disagrees with its plain version")
        return float(max(d_aw.max(), d_hw.max()))

    kacc_a, kacc_k = captured["kacc"]
    kacc_err = tower_check("fused_decode2", fd.kacc_tower,
                           fd.kacc_tower_reference, kacc_a, kacc_k)

    # ---- path A's chunk 0 through the kernels vs the plain versions
    out_ak = render(rays0, cfg_a)
    fr.fused_candidate_select = fs.fused_candidate_select_plain
    fr.fused_decode2 = fd.fused_decode2_reference
    try:
        out_ap = render(rays0, dataclasses.replace(
            cfg_a, query=dataclasses.replace(cfg_a.query,
                                             select_mode="topk")))
    finally:
        fr.fused_candidate_select = orig_fsel
        fr.fused_decode2 = fd.fused_decode2
    if not torch.equal(out_ak.ray_mask, out_ap.ray_mask):
        fail("path A: chunk ray_mask differs between kernels and plain")
    dca = (out_ak.coarse_raycolor - out_ap.coarse_raycolor).abs()
    log(f"path A chunk 0 kernels vs plain: ray_mask equal, colour max "
        f"|diff| {float(dca.max()):.3e}, mean {float(dca.mean()):.3e}")
    if not (float(dca.max()) <= ATOL and float(dca.mean()) < MEAN_TOL):
        fail("path A: chunk colour through the kernels disagrees with plain")

    # =================================================================
    # Path B: the legacy render_rays on the cloud and grid, one chunk
    # =================================================================
    cfg_b = dataclasses.replace(cfg, agg=dataclasses.replace(
        cfg.agg, fused_decode=True))
    orig_fvc, orig_pair = lr.first_valid_cols, fd.pair_tower

    def capture_fvc(qs_, bp_):
        captured.setdefault("fvc_b", (qs_, bp_))
        return orig_fvc(qs_, bp_)

    def capture_pair(*a, **k):
        captured.setdefault("pair", (a, k))
        return orig_pair(*a, **k)

    def render_b():
        return lr.render_rays(scene.params, scene.cloud, grid, scene.campos,
                              scene.camrotc2w, rays0, scene.near, scene.far,
                              cfg_b)

    lr.first_valid_cols, fd.pair_tower = capture_fvc, capture_pair
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    out_b = render_b()
    torch.cuda.synchronize()
    launches_b = dict(_cuda.LAUNCHES)
    lr.first_valid_cols, fd.pair_tower = orig_fvc, orig_pair
    log(f"path B chunk ({CHUNK} rays, D {cfg_b.query.z_depth_dim}, SR "
        f"{cfg_b.query.SR}) rendered (first pass) in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches_b}")
    qb = cfg_b.query
    m_b = min(CHUNK * (qb.compact_budget or qb.SR), CHUNK * qb.z_depth_dim)
    want_b = {"first_valid_cols": 1,
              "fused_decode": -(-m_b // qb.decode_chunk)}
    for name, n in want_b.items():
        if launches_b.get(name, 0) != n:
            fail(f"path B: kernel {name} launched "
                 f"{launches_b.get(name, 0)} times, expected {n}")
    cb, mb = out_b.coarse_raycolor, out_b.ray_mask
    if cb.shape != (CHUNK, 3) or not torch.isfinite(cb).all():
        fail("path B: colour is not finite or has the wrong shape")
    if not torch.equal(cb[~mb], bg.expand(int((~mb).sum()), 3)):
        fail("path B: miss rays are not exactly background")
    n_slots_b = int(out_b.pnt_mask.any(-1).sum())
    if not 0.05 < float(mb.float().mean()) < 0.95 or n_slots_b == 0:
        fail("path B: implausible chunk")
    # the fast cache stores bf16 relative xyz, so distances (and a few
    # boundary samples) differ between the two paths: printed only
    both = mb & outs[0].ray_mask
    d_b = (cb - outs[0].coarse_raycolor).abs()
    log(f"path B vs fast path on chunk 0: ray_mask agree on "
        f"{float((mb == outs[0].ray_mask).float().mean()):.6f} of rays "
        f"(legacy {int(mb.sum())}, fast {int(outs[0].ray_mask.sum())}), "
        f"colour on rays both hit: max |diff| "
        f"{float(d_b[both].max()):.3e}, mean {float(d_b[both].mean()):.3e}; "
        f"{n_slots_b} shading slots with a neighbour")

    # ---- first_valid_cols at path B's shapes, fused_decode vs plain
    qs_b, bp_b = captured["fvc_b"]
    cs_k, cn_k = first_valid_cols(qs_b, bp_b)
    cs_p, cn_p = first_valid_cols_reference(qs_b, bp_b)
    if not (torch.equal(cs_k, cs_p) and torch.equal(cn_k, cn_p)):
        fail("first_valid_cols differs from its plain version at path B's "
             "shapes")
    log(f"first_valid_cols == plain on qs {tuple(qs_b.shape)}, BP {bp_b}")
    pair_a, pair_k = captured["pair"]
    pair_err = tower_check("fused_decode", fd.pair_tower,
                           fd.pair_tower_reference, pair_a, pair_k)

    # ---- path B's chunk through the kernels vs the plain versions
    lr.first_valid_cols = first_valid_cols_reference
    lr.fused_decode = fd.fused_decode_reference
    try:
        out_bp = render_b()
    finally:
        lr.first_valid_cols, lr.fused_decode = orig_fvc, fd.fused_decode
    if not torch.equal(mb, out_bp.ray_mask):
        fail("path B: chunk ray_mask differs between kernels and plain")
    dcb = (cb - out_bp.coarse_raycolor).abs()
    log(f"path B chunk kernels vs plain: ray_mask equal, colour max |diff| "
        f"{float(dcb.max()):.3e}, mean {float(dcb.mean()):.3e}")
    if not (float(dcb.max()) <= ATOL and float(dcb.mean()) < MEAN_TOL):
        fail("path B: chunk colour through the kernels disagrees with plain")

    # ---- times of the new kernels at their paths' shapes (CUDA events)
    t_fs_k = cuda_ms(lambda: fs.fused_candidate_select(*fsel_args), 10, 2)
    t_fs_p = cuda_ms(
        lambda: fs.fused_candidate_select_plain(*fsel_args), 2, 1)
    t_ka_k = cuda_ms(lambda: fd.kacc_tower(*kacc_a, **kacc_k), 10, 2)
    t_ka_p = cuda_ms(lambda: fd.kacc_tower_reference(*kacc_a, **kacc_k), 2, 1)
    t_pt_k = cuda_ms(lambda: fd.pair_tower(*pair_a, **pair_k), 10, 2)
    t_pt_p = cuda_ms(lambda: fd.pair_tower_reference(*pair_a, **pair_k), 2, 1)
    t_selb_host = cuda_ms(lambda: first_valid_cols(qs_b, bp_b), 50, 3)
    t_selb_l2 = cuda_ms(lambda: first_valid_cols(qs_b, bp_b), 48, 3,
                        queued=True)
    t_selb_k = rotating_ms(lambda x: first_valid_cols(x, bp_b), qs_b)
    t_selb_sc = rotating_ms(lambda x: first_valid_cols(x, bp_b), qs_b,
                            shift=1)
    t_selb_p = cuda_ms(lambda: first_valid_cols_reference(qs_b, bp_b), 5, 1)
    frame_a_ms = [cuda_ms(lambda: render_frame(cfg_a), 1) for _ in range(3)]
    chunk_b_ms = [cuda_ms(render_b, 1) for _ in range(3)]
    log(f"path A full frame {total} rays: "
        f"{[round(t, 2) for t in frame_a_ms]} ms -> "
        f"{total / min(frame_a_ms) * 1e3:.1f} rays/s (best of 3; {smi})")
    log(f"path B chunk {CHUNK} rays: {[round(t, 2) for t in chunk_b_ms]} ms "
        f"-> {CHUNK / min(chunk_b_ms) * 1e3:.1f} rays/s (best of 3; {smi})")
    if "--probe" in sys.argv[1:]:
        probe_tower("fused_decode", (0, 1, 2, 4, 8, 6, 15), "fused_decode2",
                    lambda: fd.kacc_tower(*kacc_a, **kacc_k))
        probe_tower("fused_chunk", (0, 1, 2, 4, 16, 23),
                    "fused_chunk_decode",
                    lambda: fused_chunk_decode(*args, **kw))
    if prof_dir:
        profile_pass("staged", lambda: render_frame(cfg_a), min(frame_a_ms),
                     prof_dir)
        profile_pass("legacy", render_b, min(chunk_b_ms), prof_dir)

    # ---- the least time the card could take for each kernel's work at
    # these inputs: every input read once, every output written once,
    # over the memory rate; the tower's operations on the rows and slots
    # this data gives it, over the bf16 tensor-core rate
    C = cache.cand
    n_valid = int(m_sl.sum())
    # what a valid slot's selection must read: its C metas and the 3 bf16
    # xyz channels of its C candidates; the other payload channels are
    # needed for the selected neighbours only
    slot_bytes = C * 4 + 3 * C * 2
    pair_bytes = fs.PK * 2
    b_sel = bound(nbytes(qs) + qs.shape[0] * (BP + 1) * 4, 0)
    b_selb = bound(nbytes(qs_b) + qs_b.shape[0] * (bp_b + 1) * 4, 0)
    M0 = m_sl.shape[0]
    n_found = int(fnd_k.sum())
    w_chunk = fused_chunk_weight_bytes(scene.params)
    b_fc = bound(n_valid * slot_bytes + n_pairs * pair_bytes
                 + M0 * (4 + 36 + 1) + w_chunk + M0 * (4 + 12 + 1),
                 2 * (n_pairs * ROW_MACS + n_found * SLOT_MACS))
    b_fs = bound(int(m_a.sum()) * slot_bytes + n_pairs * pair_bytes
                 + m_a.shape[0] * (4 + 12 + 1) + nbytes(ns_k, pm_k), 0)

    def tower_bound(a, outs_):
        rows = int((a[5] != 0).sum())
        w_tower = 2 * ROW_MACS + 4 * (4 * 256 + 1)
        return bound(nbytes(*a[1:6]) + w_tower + nbytes(*outs_),
                     2 * rows * ROW_MACS)

    b_ka = tower_bound(kacc_a, fd.kacc_tower(*kacc_a, **kacc_k))
    b_pt = tower_bound(pair_a, fd.pair_tower(*pair_a, **pair_k))
    # useful tensor-core work of the three tower kernels on these inputs
    f_fc = 2 * (n_pairs * ROW_MACS + n_found * SLOT_MACS)
    f_ka = 2 * int((kacc_a[5] != 0).sum()) * ROW_MACS
    f_pt = 2 * int((pair_a[5] != 0).sum()) * ROW_MACS
    log(f"first_valid_cols qs {tuple(qs.shape)} BP {BP}: kernel "
        f"{t_sel_k:.4f} ms rotating over copies of qs past the L2 (the "
        f"scalar kernel on the same rows off their 16-byte boundaries "
        f"{t_sel_sc:.4f}), {t_sel_l2:.4f} ms on one buffer, both queued "
        f"behind a busy device; {t_sel_host:.4f} ms a call at the host's "
        f"pace; plain {t_sel_p:.4f} ms, bound {b_sel[0]:.4f} ms by "
        f"{b_sel[1]}, kernel / bound {t_sel_k / b_sel[0]:.2f}")
    log(f"first_valid_cols qs {tuple(qs_b.shape)} BP {bp_b} (path B): "
        f"kernel {t_selb_k:.4f} ms rotating (scalar kernel "
        f"{t_selb_sc:.4f}), {t_selb_l2:.4f} ms on one buffer; "
        f"{t_selb_host:.4f} ms a call at the host's pace; plain "
        f"{t_selb_p:.4f} ms, bound {b_selb[0]:.4f} ms, kernel / bound "
        f"{t_selb_k / b_selb[0]:.2f}")
    # what the candidate-major payload leaves to move: a chosen neighbour
    # is 96 contiguous bytes, 3 sectors of 32 bytes (the channel-major
    # layout cost a sector for each channel read: 48, or 42 in the chunk's
    # selection), a valid slot its C metas and 3 x C xyz values
    slot_sectors = (C * 4 + 3 * C * 2) // 32
    for nm, t_sel, out_b, n_v in (
            ("fused_candidate_select", t_fs_k, nbytes(ns_k, pm_k),
             int(m_a.sum())),
            ("chunk_select_kernel", t_fc_parts["chunk_select_kernel"],
             n_pairs * 120 + M0 * 13, n_valid)):
        sectors = n_v * slot_sectors + n_pairs * 3
        log(f"{nm}: 3 sectors a chosen neighbour, {slot_sectors} a valid "
            f"slot: {sectors} sectors, {sectors * 32 / 1e6:.1f} MB read for "
            f"{n_v} valid slots and {n_pairs} neighbours, "
            f"{sectors * 32 / PEAK_BYTES * 1e3:.4f} ms at the memory rate; "
            f"measured {t_sel:.3f} ms with its {out_b / 1e6:.1f} MB of "
            f"output")
    for nm, tk, tp, bb, fl in (
            ("fused_chunk_decode", t_fc_k, t_fc_p, b_fc, f_fc),
            ("fused_candidate_select", t_fs_k, t_fs_p, b_fs, None),
            ("fused_decode2 (M=%d)" % kacc_a[1].shape[0], t_ka_k, t_ka_p,
             b_ka, f_ka),
            ("fused_decode (M=%d)" % pair_a[1].shape[0], t_pt_k, t_pt_p,
             b_pt, f_pt)):
        work = (f", {fl / tk / 1e9:.1f} TFLOP/s of useful work"
                if fl is not None else "")
        log(f"{nm}: kernel {tk:.3f} ms, plain {tp:.3f} ms, bound "
            f"{bb[0]:.3f} ms by {bb[1]}, kernel / bound {tk / bb[0]:.2f}"
            f"{work}")

    def record(name, source, replaces, n, err, ms, plain_ms, bnd,
               flops=None, device_kernels=None, extra=None):
        rec = {"name": name, "route": "cuda",
               "source": f"pointnerf2studio_torch/csrc/{source}",
               "replaces": f"pointnerf2studio_tpu/ops/{replaces}",
               "launches": n, "max_abs_err": float(err), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": None, "ms_over_bound": ms / bnd[0]}
        if flops is not None:
            rec["useful_tflops"] = flops / ms / 1e9
        if device_kernels:   # one launch of the wrapper runs all of these
            rec["device_kernels"] = device_kernels
        rec.update(extra or {})
        return rec

    print(json.dumps({"kernels": [
        record("first_valid_cols", "first_valid_cols.cu", "select.py:41",
               launches["first_valid_cols"], sel_err, t_sel_k, t_sel_p,
               b_sel, extra={"ms_one_buffer": t_sel_l2,
                             "host_paced_ms": t_sel_host,
                             "scalar_kernel_ms": t_sel_sc,
                             "legacy_shape": {
                                 "ms": t_selb_k, "ms_one_buffer": t_selb_l2,
                                 "scalar_kernel_ms": t_selb_sc,
                                 "host_paced_ms": t_selb_host,
                                 "plain_ms": t_selb_p,
                                 "bound_ms": b_selb[0]}}),
        record("fused_candidate_select", "fused_select.cu",
               "fused_select.py:60", launches_a["fused_candidate_select"],
               fsel_err, t_fs_k, t_fs_p, b_fs),
        record("fused_decode", "fused_decode.cu", "fused_decode.py:91",
               launches_b["fused_decode"], pair_err, t_pt_k, t_pt_p, b_pt,
               f_pt),
        record("fused_decode2", "fused_decode.cu", "fused_decode.py:235",
               launches_a["fused_decode2"], kacc_err, t_ka_k, t_ka_p, b_ka,
               f_ka),
        record("fused_chunk_decode", "fused_chunk.cu", "fused_chunk.py:86",
               launches["fused_chunk_decode"], fused_err, t_fc_k, t_fc_p,
               b_fc, f_fc, t_fc_parts),
    ], "launches_by_path": {"fused_chunk": launches, "staged": launches_a,
                            "legacy": launches_b}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
