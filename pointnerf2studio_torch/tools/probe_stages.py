"""Perf probes of the fast render path's XLA route: where a chunk's time
goes, stage by stage.

    python -m pointnerf2studio_torch.tools.probe_stages --mode stages
    python -m pointnerf2studio_torch.tools.probe_stages --mode chunks
    python -m pointnerf2studio_torch.tools.probe_stages --mode ablate
    ... [--scene chair|sphere] [--device cpu]

Modes (the reference's tools/probe_chunk_stages.py, probe_chunks.py and
probe_ablate.py):

  stages  `chunk_pipeline` cut short after each stage, cumulative prefixes
          (p_gather: the row gather; p_geom: + candidate d2 and masks;
          p_knn: + the K-nearest selection; p_extract: + the payload
          extract; p_dists: + the neighbour geometry; decode: + the
          aggregation weights, the tower faked; full), each delta printed;
  chunks  `chunk_pipeline` with one stage faked (gather, knn, extract,
          weights, decode) and full;
  ablate  `fast_render_rays` end to end with each probe of PROBES, the
          front-end's and the chunk's (scatterback under the slot-grid
          composite, beside full under it).

The chunk modes feed `chunk_pipeline` real compaction outputs, computed
outside the timed calls by the reference tools' front-end (all D samples
of a ray looked up, `select_first_cols`, `rank_gather_pack`). A probe's
outputs are wrong on purpose; only its time is read. Each variant is
timed over distinct ray sets (the rays jittered by 1e-4 and normalised)
after one warm-up call on another set, the device synchronised once at the
end: ms a call, over 8 timed sets on the card and 2 on the CPU.

Settings are the reference tools': 558,000 points, 65,536 rays (a
128 x 512 view tiled), compact budget 8, fast_chunk 4096, D 400 on the
chair and 180 on the sphere, voxel 0.004, a bf16 aggregator with random
weights from seed 0. It runs on the card unless `--device cpu` is given;
on the CPU it runs 30,000 points, 2,048 rays and voxel 0.016.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from pointnerf2studio_torch.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig)
from pointnerf2studio_torch.data.synthetic import (
    camera_rays, make_chair_scene, make_sphere_scene)
from pointnerf2studio_torch.models import fast_render as fr
from pointnerf2studio_torch.ops._cuda import resolve_device
from pointnerf2studio_torch.ops.select import (
    rank_gather_pack, select_first_cols)

STAGES = ("p_gather", "p_geom", "p_knn", "p_extract", "p_dists", "decode",
          "full")
CHUNKS = ("gather", "knn", "extract", "weights", "decode", "full")
ABLATE = ("full",) + fr.PROBES + ("full_grid",)
# the scenes' depth samples and the focal of the probed view (the
# reference tools' 128 x 512 view)
SCENES = {"chair": (400, 711.0), "sphere": (180, 320.0)}
VIEW_H, VIEW_W = 128, 512
# (points, rays a chunk, voxel, timed ray sets) on the card and on the CPU
SIZES = {"cuda": (558_000, 65_536, 0.004, 8), "cpu": (30_000, 2048, 0.016, 2)}


def probe_config(scene: str, vsize: float) -> PointNerfConfig:
    """The reference tools' config (tools/probe_bench_variants.base_cfg)
    on the XLA route, with the selection kernel for the front-end."""
    return PointNerfConfig(
        query=QueryConfig(
            vsize=(vsize,) * 3, vscale=(2, 2, 2), SR=80, K=8, P=12,
            max_o=700_000, z_depth_dim=SCENES[scene][0], compact_budget=8,
            ray_slot_budget=32, use_cache=False, fast_chunk=4096,
            select_mode="pallas"),
        agg=AggregatorConfig(compute_dtype="bfloat16"))


def jittered(rays: torch.Tensor, count: int, seed: int = 0):
    """`count` distinct copies of `rays` [R, 3], each jittered by 1e-4
    normal noise (drawn on the host from `seed`) and normalised."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for _ in range(count):
        r = rays + 1e-4 * torch.randn(rays.shape, generator=gen).to(
            rays.device)
        out.append(r / torch.linalg.norm(r, dim=-1, keepdim=True))
    return out


def ray_sets(camrotc2w: torch.Tensor, n_rays: int, count: int,
             focal: float):
    """`count` distinct [n_rays, 3] ray sets: the 128 x 512 view tiled to
    n_rays rays, jittered (`jittered`)."""
    rd0 = camera_rays(camrotc2w, VIEW_H, VIEW_W, focal)
    tiled = rd0.repeat(-(-n_rays // rd0.shape[0]), 1)[:n_rays].contiguous()
    return jittered(tiled, count)


@torch.no_grad()
def compaction(cache, cfg: PointNerfConfig, campos, raydirs, near, far,
               ranges_min, scaled_vsize):
    """The compaction outputs `chunk_pipeline` takes, from the reference
    tools' front-end: every one of the D samples of a ray looked up in the
    qslot table, the first BP valid columns (`select_first_cols`, the
    kernel under select_mode="pallas") packed to M = R * compact_budget
    slots. Returns (qslot_c, sel_ray, sel_d, mask_c)."""
    q = cfg.query
    R, D = raydirs.shape[0], q.z_depth_dim
    BP = q.ray_slot_budget or min(q.SR, 32)
    dev = raydirs.device
    near = torch.as_tensor(near, dtype=torch.float32, device=dev)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev)
    step_t = (far - near) / D
    t_mid = near + (torch.arange(D, device=dev, dtype=torch.float32)
                    + 0.5) * step_t
    qs = fr.qslot_lookup(cache, campos + raydirs[:, None, :]
                         * t_mid[None, :, None], ranges_min, scaled_vsize)
    qs = qs.to(torch.int32).contiguous()
    col_sel, cnt, _ = select_first_cols(qs, BP, min(q.SR, BP, D),
                                        q.select_mode)
    sel_ray, _, colm, _, qslot_c, mask_c = rank_gather_pack(
        qs, col_sel, cnt, R * q.compact_budget)
    return qslot_c, sel_ray, colm, mask_c


def chunk_outputs(scene, cache, cfg: PointNerfConfig, ranges_min,
                  scaled_vsize, raydirs, comp, probe: str):
    """`chunk_pipeline` on the compaction outputs `comp`, with the probe
    `probe` ("full": none). Returns (sig, rgb, found, pb)."""
    dev = raydirs.device
    near = torch.as_tensor(scene.near, dtype=torch.float32, device=dev)
    far = torch.as_tensor(scene.far, dtype=torch.float32, device=dev)
    return fr.chunk_pipeline(
        scene.params, scene.cloud.Rw2c, cache, raydirs, scene.campos,
        scene.camrotc2w, near, (far - near) / cfg.query.z_depth_dim, cfg,
        ranges_min, scaled_vsize, *comp,
        debug_ablate=None if probe == "full" else probe)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, inputs, warmup_input, device) -> float:
    """ms a call of `fn` over the distinct `inputs`, after one call on
    `warmup_input`; the device is synchronised before and after."""
    fn(warmup_input)
    synchronize(device)
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / len(inputs)


def chunk_inputs(scene, cache, cfg: PointNerfConfig, ranges_min,
                 scaled_vsize, rays):
    """(rays, compaction outputs) of each ray set: the chunk modes'
    inputs."""
    return [(r, compaction(cache, cfg, scene.campos, r, scene.near,
                           scene.far, ranges_min, scaled_vsize))
            for r in rays]


def probe_times(mode: str, scene, cache, cfg: PointNerfConfig, ranges_min,
                scaled_vsize, inputs, variants=None, log=print) -> dict:
    """{variant: ms a call} for `mode` ("stages", "chunks" or "ablate") on
    `inputs`, the last of them the warm-up's: ray sets for "ablate", and
    `chunk_inputs` for the chunk modes. Each is printed as it is taken,
    stages with the delta to the previous prefix."""
    dev = scene.campos.device
    variants = variants or {"stages": STAGES, "chunks": CHUNKS,
                            "ablate": ABLATE}[mode]
    if mode == "ablate":
        grid = dataclasses.replace(cfg, query=dataclasses.replace(
            cfg.query, composite_mode="grid"))

        def make(v):
            cf = grid if v in ("scatterback", "full_grid") else cfg
            probe = None if v in ("full", "full_grid") else v
            return lambda r: fr.fast_render_rays(
                scene.params, scene.cloud.Rw2c, cache, scene.campos,
                scene.camrotc2w, r, scene.near, scene.far, cf, ranges_min,
                scaled_vsize, debug_ablate=probe)
    else:
        def make(v):
            return lambda x: chunk_outputs(scene, cache, cfg, ranges_min,
                                           scaled_vsize, x[0], x[1], v)
    times, prev = {}, None
    for v in variants:
        ms = time_calls(make(v), inputs[:-1], inputs[-1], dev)
        times[v] = ms
        delta = (f"  (+{ms - prev:8.2f})" if mode == "stages"
                 and prev is not None else "")
        log(f"{mode} {v:12s}: {ms:9.2f} ms{delta}")
        prev = ms
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("stages", "chunks", "ablate"),
                    default="stages")
    ap.add_argument("--scene", choices=tuple(SCENES), default="chair")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_points, n_rays, vsize, iters = SIZES[dev.type]
    cfg = probe_config(args.scene, vsize)
    t0 = time.perf_counter()
    make = make_chair_scene if args.scene == "chair" else make_sphere_scene
    scene = make(n_points, seed=0, cfg=cfg, device=dev)
    cache, rmin, svs = fr.make_fast_scene(cfg, scene.cloud, scene.grid)
    rays = ray_sets(scene.camrotc2w, n_rays, iters + 1,
                    SCENES[args.scene][1])
    synchronize(dev)
    n_valid = int(compaction(cache, cfg, scene.campos, rays[0], scene.near,
                             scene.far, rmin, svs)[3].sum())
    print(f"{args.scene}: {n_points} points, {n_rays} rays, D "
          f"{cfg.query.z_depth_dim}, M {n_rays * cfg.query.compact_budget}, "
          f"{n_valid} valid slots, {-(-n_valid // cfg.query.fast_chunk)} "
          f"live chunks of {cfg.query.fast_chunk}; set up in "
          f"{time.perf_counter() - t0:.1f} s on {dev}", flush=True)
    if dev.type == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    inputs = (rays if args.mode == "ablate" else
              chunk_inputs(scene, cache, cfg, rmin, svs, rays))
    return probe_times(args.mode, scene, cache, cfg, rmin, svs, inputs,
                       log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
