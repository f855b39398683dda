#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pointnerf2studio_torch/csrc/` with
nvcc (sm_90a), builds the 558k-point procedural chair scene, its voxel
grid and its fused-layout candidate cache on the GPU, and renders the
whole 800x800 frame (focal 1111.1, 400 samples per ray, K = 8, bf16
aggregator of hidden 256 / colour 128, random weights from seed 0)
through `fast_render_rays` in 65,536-ray chunks, with the depth window
and ray budget measured on the frame as the JAX bench sizes them.

It fails (non-zero exit, no result line) when there is no CUDA device,
when a kernel does not build or launch, when a kernel of the path was
not launched during the frame, when an exactness counter is non-zero,
when a kernel disagrees with its plain PyTorch version on one chunk's
real inputs (first_valid_cols: exactly; fused_chunk_decode: `found`
exactly, rgb within 2e-2, sigma within 2e-2 + 2^-7 |sigma|, mean |diff|
< 2e-3), or when the
chunk rendered through the kernels differs from the chunk rendered
through the plain versions (ray_mask exactly, colour within the same
bound). Printed before the last line: the card's name and power limit,
build and phase times, each kernel's and its plain version's time at the
path's shapes, the frame's rays/s, and one JSON line of kernel records.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
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


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pointnerf2studio_torch.data.synthetic import (
        camera_rays, make_chair_scene)
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops.fused_chunk import (
        fused_chunk_decode, fused_chunk_decode_reference)
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

    def render(rays, c=cfg):
        return fr.fast_render_rays(
            scene.params, scene.cloud.Rw2c, cache, scene.campos,
            scene.camrotc2w, rays, scene.near, scene.far, c, rmin, svs)

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
    outs = [render(raydirs[i * CHUNK:(i + 1) * CHUNK])
            for i in range(n_chunks)]
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
    sig_p, rgb_p, fnd_p = fused_chunk_decode_reference(*args, **kw)
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
    fr.fused_chunk_decode = fused_chunk_decode_reference
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
    t_sel_k = cuda_ms(lambda: first_valid_cols(qs, BP), 50, 3)
    t_sel_p = cuda_ms(lambda: first_valid_cols_reference(qs, BP), 20, 2)
    t_fc_k = cuda_ms(lambda: fused_chunk_decode(*args, **kw), 10, 2)
    t_fc_p = cuda_ms(lambda: fused_chunk_decode_reference(*args, **kw), 2, 1)
    log(f"first_valid_cols qs {tuple(qs.shape)}: kernel {t_sel_k:.4f} ms, "
        f"plain {t_sel_p:.4f} ms")
    log(f"fused_chunk_decode M={m_sl.shape[0]}: kernel {t_fc_k:.3f} ms, "
        f"plain {t_fc_p:.3f} ms")

    frame_ms = [cuda_ms(lambda: [render(raydirs[i * CHUNK:(i + 1) * CHUNK])
                                 for i in range(n_chunks)], 1)
                for _ in range(3)]
    best = min(frame_ms)
    log(f"full frame {total} rays: {[round(t, 2) for t in frame_ms]} ms -> "
        f"{total / best * 1e3:.1f} rays/s (best of 3; {smi})")

    print(json.dumps({"kernels": [
        {"name": "first_valid_cols", "route": "cuda",
         "source": "pointnerf2studio_torch/csrc/first_valid_cols.cu",
         "replaces": "pointnerf2studio_tpu/ops/select.py:41",
         "launches": launches["first_valid_cols"],
         "max_abs_err": float(sel_err), "ms": t_sel_k, "plain_ms": t_sel_p},
        {"name": "fused_chunk_decode", "route": "cuda",
         "source": "pointnerf2studio_torch/csrc/fused_chunk.cu",
         "replaces": "pointnerf2studio_tpu/ops/fused_chunk.py:86",
         "launches": launches["fused_chunk_decode"],
         "max_abs_err": fused_err, "ms": t_fc_k, "plain_ms": t_fc_p},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
