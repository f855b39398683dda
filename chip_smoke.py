#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pointnerf2studio_torch/csrc/` (seven
sources and four headers: the tuned tower and the generic tower, each
shared by two sources, the selection and the fused chunk's selection
kernel) with nvcc (sm_90a), one nvcc a source, all started together,
builds the 558k-point procedural chair scene,
its voxel grid and its candidate cache (metas, candidate-major payload,
xyz planes) on the GPU, and drives three
paths and then the reference's default frame front-ends (4 to 7 below)
at the full width of the chair model (focal 1111.1, 400 samples
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
     with the fast path on those rays is printed, not asserted;
  4. the march frame: the distance-field walk (kernel march_rays, one
     launch a stage) planned on the host as the JAX bench plans it, in
     front of the fused chunk, held to frame 1 bit for bit; march_rays
     against its plain version on chunk 0's rays, as planned and with fuel
     and buckets starved, and its iterations against `simulate_march`;
  5. the raster frame: the footprint ladder measured on the camera, one
     emit program a frame, its table equal to the march's on all 640,000
     rays, the chunks rendered from it (`premarch`), held to frame 4;
  6. `render_frame` (rays sorted on the host, dense chunks, the budget
     escalation), walked and with `raster=`: the second must say that the
     raster rendered it, and both equal frame 4 bit for bit;
  7. the frame times of the depth window, the march, the raster and both
     `render_frame` routes, best of 3 warm frames taken in turns;
  8. the payload check: chunks 0-1 with the tower's payload inputs scaled
     by PAYLOAD_SCALE, through the fused-chunk kernels, the staged kernels
     and the plain versions, held together at ATOL / MEAN_TOL; the plain
     route on a payload whose 16-byte pieces are rotated must fail that
     bound (its difference under the scene's own weights is printed too);
  9. the train path (`models/fast_train.py`, `train/`): 4 views of 800x800
     at the frame's focal on the chair's camera ring, one constant colour,
     4096-ray steps at jitter 0.3 with the chair's query config and the
     scene's random bf16 weights, the ray budget sized on the views. On
     one fixed batch and jitter draw the dense step (first_valid_cols)
     and the march step (march_rays, planned by `plan_train_march`) each
     equal their plain-route step, the dense step run twice equals itself
     and the march step equals the dense step: loss, every gradient and
     every updated weight bit for bit, counters 0. Then `fit()` takes 100
     steps per front-end (sampling on the device) with first_valid_cols
     launched once a dense step and march_rays once a stage of every
     march step; the loss of steps 91-100 must be at most a quarter of
     steps 1-10's, and both runs end bit-equal. Train it/s per front-end:
     10 warm-up steps, then the median of 3 windows of 20, in turns.
 10. routes: the reference's opt-in routes on chair-800p's scene, cache
     and weights at full width, each over the whole frame (10 chunks of
     65,536 rays) and held to its counterpart: the XLA route (chunks of
     ROUTE_XLA_CHUNK slots) and its two-phase pipeline (decode_chunk2)
     under tests/test_raster.py's contract (ray_mask equal, colour within
     1e-3, under 0.1% of the components apart); chunk_mode="fused" with
     fused_decode2 (#1, #2 and #4 once a chunk) bit-equal to path 2's
     staged frame, and with agg_intrp_order 1 (#1, #2, the torch decode
     tail) within ATOL / MEAN_TOL of the order-1 XLA frame; the pair
     decode within 2e-2 / mean 1e-3 of the lanes, no pb_overflow at a
     budget of K and some when starved (chunk 0, budget 1, compact budget
     4); krows on the slim view and cand_prune on a cache of its own (its
     width printed) bit-equal to the XLA frame; base_cache within ATOL /
     MEAN_TOL of it; span tiers from `measured_span_tiers` bit-equal to
     the flat window (both at compact budget 0); coarse_step 2 and 4
     (the window budget doubled from 12 until chunk 0 drops none) and the
     one-hot compaction bit-equal to the frames without them; the grid
     composite within 1e-5 of the packed; `render_frame` through a
     `render_maker` bit-equal to the default. Every counter zero (but the
     starved pair budget's), launches counted per route, each route's
     frame ms beside the XLA frame's (one warm frame each, in turns). On
     chair-train's fixed batch and jitter draw: the one-hot / grid step
     against the topk / packed step (loss within 1e-5 relative, colour
     within 1e-5, gradients within rtol 1e-3 / atol 1e-5, the reference's
     bound for that pair), remat "selection" and "full" against "none"
     (loss and gradients bit for bit), and each remat mode's it/s and a
     step's peak bytes, in turns.
 11. the reference's default route (`QueryConfig.use_cache`, `fit` with
     `fast_path=False`): the grid's candidate cache (max_q of the fat
     cache, cand_cap 64) built on the card; chunk 0 through the legacy
     `render_rays` on it with fused_decode on (first_valid_cols once on
     the qslot table, fused_decode once a decode piece), held to the plain
     versions (ray_mask exactly, colour within 2e-2, mean < 2e-3); a cache
     at cand_cap = V * P against the grid K-NN on the same samples (the
     neighbour sets of every slot bit for bit, the reference's guarantee;
     the slots in the same order are counted); each of the five weight
     kernels of fused_decode's gate on 8,192 rays through the kernel and
     through `decode_radiance` within the same bound; the chunk's time on
     the cache and on the grid in turns. Then the legacy train step on the
     train phase's batch and jitter (first_valid_cols once on qs [4096,
     400], fused_decode never): kernel step == plain step and a step twice,
     bit for bit; at float32 against the fast step without ray packing and
     with SR slots a ray, loss within rtol 1e-4 and every gradient within
     rtol 2e-3 / atol 1e-6; `fit(fast_path=False)` 100 steps, the loss down
     at least 4x; its it/s beside the fast dense step's, in turns, each
     also with the gather backward's prefix sums as one 1-D torch.cumsum
     (the scan that `neural_points._prefix_sums` replaced); one step
     under the profiler split into forward, backward and optimizer, where
     torch's `indexing_backward_kernel` must not appear, and again with
     the 1-D scan.
 12. structure: growth, pruning, evaluation and checkpoints on the
     chair-train scene, with the scene's weights rescaled for the phase
     (mlp_base's first layer x4, the density head x30: at the scene's own
     every hit ray's max opacity is the same to four digits) and a tenth
     of the preset's learning rates (the preset's zero that tower's density
     in two steps); the legacy step at the chair preset's compact_budget 0,
     fused_decode on for evaluation, prob_mul 0.4, prune_thresh 0.1. Four
     teacher views of the intact cloud through `render_frame`; the probe
     threshold, the median of view 0's max shading opacity before the cut;
     the probe's fat cache (bytes, seconds); one 65,536-ray chunk of view
     0 through the XLA route on it against the fused-chunk route (ray_mask
     exactly, colour within ATOL / MEAN_TOL), its prob outputs with
     first_valid_cols and with the plain version bit for bit, and the two
     chunks' times in turns; an azimuth wedge of 40 degrees facing view 0
     cut from the cloud; view 0's 640,000 rays through the fast and the
     legacy prob probe (ray_mask agreement >= 0.99, the max-opacity
     location within a voxel on >= 0.9 of the rays both hit; where it is
     the same sample, the opacity within 2e-2 and the averages within
     3e-2 on >= 0.9 of them, the share printed); `probe_and_grow` (grown
     > 0, >= 80% of the
     grown points in the wedge widened by a voxel, n_alive up by the grown
     count, the grown slots' Adam moments zero); `fit()` 100 steps with
     prunes at 40 and 80 (each kills exactly the live points under the
     threshold), growth at 50 and 100, saves and evaluations at 50 and 100
     (first_valid_cols once a step and once a probe chunk, fused_decode
     once a decode piece of the legacy evaluation), the colour loss of
     steps 91-100 at most that of steps 1-10, three finite evaluations;
     `fit()`
     again on the same directory restores the finished run bit for bit
     without a step, and with max_steps 110 resumes at 101; the `.pth`
     export read back bit for bit; view 0 evaluated through the legacy
     renderer and through `render_frame` within 0.5 dB of PSNR.
 13. plane: the plane background (`models/bg_plane.py`) on the chair: 4
     views of 400x400 on the chair's ring rendered by `render_frame` through
     the fused chunk (#5) and composited over a ground plane of colour
     (0.5, 0.5, 0.5) at z = -1 (normal (0, 0, -1), which every ray of these
     views meets with dot >= 1e-3); `create_all_bg` on the card against
     the same call on the host (pixels apart by more than 1e-5, ceil flips,
     at most 0.1%; at least half the plane's pixels valid); 50 steps of
     `fit(bgmodel="plane")` on the fast step and on the legacy step from
     the scene's weights with 10% noise, each loss falling, the legacy
     run's evaluation through #3 and, after the fast run, view 0 through
     `render_frame` and #5 with the plane's background.
 14. large scene: the reference's ScanNet stress room
     (`tools/stress_scannet_scale.py`: 2,000,000 points, vsize 0.008 x
     vscale 2, D 288, SR 24, K 8, max_o 4M, cand_cap 32, compact budget 8,
     24 slots a ray, fast_chunk 4096, a bf16 aggregator at full width,
     density bias +5, near 0.2, far 9.0) on the hash grid: its build
     (dims, n_occ, n_q, buckets, table bytes, seconds) against the dense
     grid of the same cloud (n_occ and n_q equal, `table_qslot` equal to
     the dense qslot table on every voxel of the box); the hash fat cache
     against the dense one, bit for bit on the first n_q rows; the 640x480
     frame from (0, -2.4, 1.4) at focal 580 through the XLA route in
     65,536-ray chunks at SR slots a ray (M cannot cut a sample) on both
     caches, bit-equal, counters zero, #1 once a chunk, timed in turns;
     the qslot lookup of chunk 0's samples through each table (device ms,
     and the hash walk's peak memory); the
     same frame with `fused_decode2` (#4) within ATOL / MEAN_TOL of it, #4
     against its plain version; 10 views inside the room (8 of 640x480
     to train, 2 of 320x240 held out) rendered by `render_frame` through
     the dense twin's fused chunk (#5); a far cluster (the first 50,000
     points + 41 m on each axis): the dense build refuses it,
     `grid_mode="auto"` gives the hash grid with the room's ranges_min,
     the room's cache rows unchanged, the frame equal to the room frame
     bit for bit; `fit()` on the hash grid
     100 steps of 4,096 rays (masked colour loss down at least 2x, #1 once
     a step, evaluations at 50 and 100 through `render_frame` on the hash
     cache) from the teacher's weights with the colour head's bias lowered
     by 0.5, and `fit(grid_mode="dense")` twice from the same start: the
     first step bit-equal, the loss gaps after 100 steps printed; it/s,
     peak device memory, PSNR.
 15. data: the user's data path and entry point on the procedural chair.
     `generate_chair_dataset` (style v2, ss 2, 400x400, 64 train and 8
     test views, seed 0, depth maps) traced on the card and read back by
     `load_blender` (PIL is required: the run fails without it); test
     view 0 traced on the card and on the host
     (the rays whose hit mask differs at most 0.5%, and at least 99.5% of
     the rays both hit within 2e-4 in colour); the point cloud from the
     depth maps (stride 2, max depth 6, vox_res 320, "rand" features, conf
     0.3: tools/validate_chair.py's --init depth); `fit()` on the chair
     preset at full width (bf16, D 400, SR 80, K 8, 4096-ray legacy steps
     with select_mode="pallas", fused_decode on) for DATA_STEPS steps, a
     depth cut of the preset's 200,000, evaluating test views 0-1 every
     DATA_EVAL_FREQ steps: first_valid_cols once a step and once an
     evaluation chunk, fused_decode in every evaluation, the held-out PSNR
     rising; its curve beside the JAX package's record and the time to
     DATA_TARGET_DB; test view 0 of the trained chair through the fused
     chunk (`render_frame`, chunk_mode="fused") and through the legacy
     route with fused_decode, each against its plain route (ray_mask
     exactly, colour within 2e-2, mean < 2e-3); then the command line in
     this process (`cli.main`, the card by default) on fit()'s exported
     `<step>_net_ray_marching.pth`: eval and eval --fast (their PSNR beside
     fit()'s last), render-video --fast to an 8-frame GIF (where imageio
     is present), evaluate-images, visualize, edit (the chair and a copy
     shifted 2 m: twice the alive points), gen-points --from-ply on a PLY
     of the depth cloud and train --max-steps 20 from it; each command
     must return normally.
  16. mvs: MVSNet point generation and joint MVS training on the data
     phase's dataset, with random weights written from seeds in the
     reference's checkpoint layouts (model_000014.ckpt, best_net_mvs.pth)
     and read by the port's loaders. `mvsnet_depth` at full width on view
     batch 0 (three 400x400 views, 100x100 features, 192 planes) on the
     card and on the host: depth within 1e-4 of the far plane, the
     probability within 1e-4, the truncated expectation index apart on at
     most 1% of the pixels and the confidence within 1e-4 where it agrees;
     its device ms (the median of 5 warm calls; the cost-volume build and
     the 3-D U-Net by the profiler) and peak memory. `generate_point_cloud`
     over all 64 view batches (num_src 2, vox_res 320, the chair's ranges,
     the alpha hull) in "mvsnet" mode (the share of pixels each filter
     keeps; random weights leave no point, and the port raises there) and
     in "gt" mode (the dataset's depth maps: a real cloud, its count beside
     the data phase's); both modes on the first 8 batches on the card and
     on the host: the stage counts and the point count within max(8, 1%)
     points, the positions matched within 1e-5, the attributes of the
     matched points within MVS_ATTR_TOL (2e-3: they are bilinear samples of
     the views at the positions).
     `fit()` on the gt-mode cloud as the data phase trains, 1,000 steps,
     evaluating test views 0-1 every 500 (#1 once a step and once an
     evaluation chunk; the PSNR rising). The joint step at full width:
     the chair preset, 4,096 rays a step, 128 planes, a 100x100 cloud a
     step, the gate open (dprob_thresh 0.0), 100 steps: it/s (the median
     of windows of 20 after 10 warm-up steps), peak memory, the valid
     points by step (at least 90% at the first), the loss of steps 91-100
     below that of steps 1-10, every group moved, #1 launched once a step; one step's device ms by part (MVS forward, render,
     backward, optimizer); one step through #1 and through its plain
     version from copies of the state: the same selection, the loss within
     1e-6 relative and each group's gradient within 1e-4 of its norm. The
     command line: gen-points with the two checkpoints (--max-batches 4)
     and train-joint --steps 5 at the reference's gate (0.8), each allowed
     to end in the port's ValueError for an empty cloud. LPIPS (alex,
     random weights) of the trained chair's test view 0 on the card and on
     the host within 1e-4 relative.
  17. multi: multi-device execution (`parallel/`) on the one card. The
     parent saves the chair scene, its weights, the frame's rays and the
     train phase's batch and jitter draw; each rank is a process of its own
     (`sharding.run_ranks`) that loads them and builds its grid and caches
     on the card, and every rank's results must equal rank 0's. (a) One
     NCCL rank: the sharded legacy step (on the grid) and the sharded fast
     dense step equal the parent's unsharded steps bit for bit (loss,
     gradients, updated weights; float32 compute), and
     `make_sharded_fast_render` renders chunk 0 as the direct call does,
     bit for bit. (b) Two gloo ranks
     sharing the card, a 1-D mesh: the ray-sharded fused-chunk frame
     equals the parent's frame bit for bit, counters 0 and their sums the
     single frame's; chunk 0 through the legacy render at compact budget 0
     with fused_decode bit for bit; both sharded steps within 1e-6 of the
     loss and 1e-5 of each gradient's max (float32: at bfloat16 each rank's
     weight gradients are bf16-rounded before the sum); `fit(mesh=)`
     MULTI_FIT_STEPS legacy steps on the host sampler's batches, the loss
     of the last window at most a quarter of the first. (c) Four gloo
     ranks, a 2x2 mesh: the point-sharded legacy step within the same
     bound, each rank holding half of the attribute rows and moments; the
     XLA frame with fused_decode2 on the point-sharded fat cache bit-equal
     to the parent's unsharded one (each rank's cache bytes beside the
     whole); the slab-sharded query on chunk 0's rays equal to the
     unsharded query (neighbour sets, locations, masks); the reference's
     structure sequence (capacity expansion, a legacy probe and growth on a
     MULTI_PROBE_HW view, a prune), re-sharding after each event, then a
     step, every rank's state equal. (d) `cli train --num-devices 2` must
     raise "need 2 devices, have 1". Each rank's launches by job, peak
     bytes and seconds are printed; the sharded it/s is gloo on one card,
     not a multi-GPU rate.
  18. probes (run right after the routes phase): the render probes of the
     XLA route (`chunk_pipeline` and `fast_render_rays` with debug_ablate;
     pointnerf2studio_torch/tools/probe_stages.py) on chair-800p's scene,
     cache and weights, with the reference tools' front-end (all 400
     samples of a ray looked up, #1, the slots packed at compact budget 8)
     on chunk 0 of the frame. The tool's compaction and its slots'
     geometry must be what fast_render_rays' XLA route hands its chunk
     body, and `chunk_pipeline(None)` on them must return what the body
     returned, bit for bit (one body: a determinism check). Then the cumulative cut-offs (p_gather,
     p_geom, p_knn, p_extract, p_dists, decode, full), the single-stage
     fakes (gather, knn, extract, weights, decode) and full with
     fused_decode2 (#4), each timed over PROBE_SETS jittered copies of the
     chunk's rays after a warm-up on another (ms a call, the deltas of the
     prefixes printed); #1's launches in the front-end and #4's in the
     fused_decode2 runs go into the kernels line as "probes". Every
     cut-off's outputs on the card must equal the port's CPU run of it on
     the first PROBE_CPU_SLOTS slots: found and pb exactly, sigma within
     ATOL + SIG_RTOL |sigma|, rgb within ATOL, mean |diff| < MEAN_TOL.
  19. widths (the last phase): the generic kernels (csrc/decode_any.cu,
     csrc/chunk_any.cu, fused_candidate_select_any of csrc/fused_select.cu)
     at widths the tuned kernels are not built for, on chair-800p's scene
     at full size and depth (558,000 points, 800x800, 400 samples a ray,
     the frame's depth window and ray budget), random weights from seed 0
     at each width (density bias +5, as the scene's). "wide": K 16 of
     cand_cap 128 (a fat cache of its own, 7.25 GB of kcand; the C = 64
     cache stays, so that the two frames are timed in turns), hidden 512,
     colour 256 x 4 layers, PE octaves (4, 6, 5): the fused-chunk frame
     (#1 and fused_chunk_decode_any once a chunk), the staged chunk 0 (#1,
     fused_candidate_select_any, fused_decode2_any) and one legacy chunk
     with fused_decode (#1, fused_decode_any once a decode piece), then the
     flagship frame and the wide frame in turns (flagship, wide, wide,
     flagship). "narrow": K 4 of cand_cap 32, hidden 128, colour 64 x 2,
     octaves (2, 4, 3): the staged chunk 0 (#1, the tuned selection,
     fused_decode2_any), the XLA route's chunk 0 with fused_decode2 (#1,
     fused_decode2_any once a live chunk) and one legacy chunk at 16
     features (#1, fused_decode_any), whose towers are held again at 3
     dists (agg_dist_pers 0) on the same rows. Every render computes the
     neighbour dists 6 wide and the fast path's payload holds 32 features,
     in the reference too, so the renders take 6 dists and the fast ones
     32 features. Each run's launches are checked exactly (the tuned
     kernels launched 0 times), every exactness counter is 0, and each
     generic kernel is held to its plain version on chunk 0's inputs:
     selections, masks and `found` exactly, colour within ATOL / MEAN_TOL,
     sigma within ATOL + SIG_RTOL |sigma|, hw under `tower_check`'s bounds;
     the staged chunk 0 against the fused-chunk frame's (wide) and the XLA
     route's against the staged one (narrow): ray_mask equal, colour
     within ATOL / MEAN_TOL. Printed: kernel ms (queued behind a busy
     device where under 50 us), plain ms and the bound at these widths,
     the frames' ms in turns, peak device memory; the generic kernels join
     the kernels line.

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
with mean |diff| of hw <= 2^-8 mean |hw|, mean over both < 2e-3;
march_rays: exactly), when a front-end's frame is not bit-equal to the
frame it is held to, when first_valid_cols is launched behind the march
or the raster, or when a path's first chunk rendered through the kernels
differs from the same chunk rendered through the plain versions
(ray_mask exactly, colour within the same bound), when a check of the
payload phase, of the train phase, of the routes phase, of the probes
phase, of the legacy phase, of the structure phase, of the plane phase,
of the large-scene phase, of the data phase, of the mvs phase, of the
multi phase (a failed rank fails the phase) or of the widths phase fails. Printed
before the last line: the card's name and power limit, build and phase times, each
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

also runs one warm pass of each path, the march frame and the raster
frame included, under torch.profiler after its timing and prints, per path, the device time by kernel name (the ten
largest), their sum and the device's idle share of the unprofiled pass
(1 - device time / pass time); the full tables go to
`DIR/profile_<path>.txt` (DIR defaults to `build/profile`). A train step
of each front-end is profiled in three parts, its forward (the render
and the losses), its backward and its optimizer update, each under its
own profiler pass, beside the unprofiled step's time.

    python3 chip_smoke.py --probe

also builds `csrc/fused_decode.cu` and `csrc/fused_chunk.cu` with parts
of the kernels left out (`TOWER_PROBE` in `csrc/tower.cuh`) and prints
fused_decode2's and fused_chunk_decode's time with each build on their
paths' inputs: what each part costs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
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
# the payload check's scale of the tower's payload inputs
PAYLOAD_SCALE = 4.0
# the train phase: rays a step, steps of each fit() run, the views' colour
TRAIN_RAYS, TRAIN_STEPS, TRAIN_COLOUR = 4096, 100, (0.8, 0.3, 0.1)
# the structure phase: the hole's azimuth wedge (degrees), fit()'s steps,
# and the query voxels the grids keep beyond the frame cache's max_q for
# the points that growth adds
STRUCT_WEDGE_DEG, STRUCT_STEPS, STRUCT_MAXQ_MARGIN = 40.0, 100, 65_536
# the structure phase's scales of the scene's random weights (see
# structure_phase): mlp_base's first layer, the density head
STRUCT_BASE_SCALE, STRUCT_DENSITY_SCALE, STRUCT_LR_SCALE = 4.0, 30.0, 0.1
# the large-scene phase: the reference's ScanNet stress room
# (tools/stress_scannet_scale.py), its voxel and depth, its frame, the train
# views, fit()'s steps, the far cluster (points, metres on each axis) and
# the student's start: the teacher's weights with the colour head's output
# bias lowered by ROOM_COLOUR_SHIFT (at random weights the colour of every
# ray is close to the same grey, so noise on the weights barely moves the
# loss, and steps from there only add noise)
ROOM_POINTS, ROOM_VSIZE, ROOM_D = 2_000_000, 0.008, 288
ROOM_H, ROOM_W, ROOM_FOCAL = 480, 640, 580.0
ROOM_VIEWS, ROOM_STEPS, ROOM_COLOUR_SHIFT = 8, 100, 0.5
ROOM_FAR_POINTS, ROOM_FAR_SHIFT = 50_000, 41.0
# the plane phase: its views (pixels a side, focal), fit()'s steps, the
# relative noise on the student's weights and the ground plane under the
# chair
PLANE_HW, PLANE_FOCAL, PLANE_STEPS, PLANE_PERTURB = 400, FOCAL / 2, 50, 0.1
PLANE_PNT, PLANE_NORMAL = (0.0, 0.0, -1.0), (0.0, 0.0, -1.0)
PLANE_COLOUR = (0.5, 0.5, 0.5)
# the data phase: the procedural chair's views (pixels a side, train and
# test views), fit()'s steps and evaluation cadence, the PSNR the run's
# time is read at, and the JAX package's record on the same scene
# (VALIDATION_RESULTS.json: the point count from depth, and the first
# evaluation of its curve, step and dB)
DATA_HW, DATA_TRAIN, DATA_TEST = 400, 64, 8
DATA_STEPS, DATA_EVAL_FREQ, DATA_TARGET_DB = 2000, 500, 20.0
DATA_JAX_POINTS, DATA_JAX_RECORD = 136_192, (2504, 22.18)
# the mvs phase: MVSNet's depth planes, the batches held card against host,
# fit() on the generated cloud, the joint steps and their depth planes
MVS_BINS, MVS_CPU_BATCHES = 192, 8
# card against host, the attributes of matched generated points: colour and
# features are bilinear samples of the views, so a position apart by the
# match tolerance (1e-5) moves a sample by 1.4e-3 px at focal 555 and depth
# 4, and an 8-bit edge moves its value by up to that much
MVS_ATTR_TOL = 2e-3
MVS_FIT_STEPS, MVS_EVAL_FREQ = 1000, 500
JOINT_STEPS, JOINT_DEPTH = 100, 128
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


def tower_bound(a, outs_):
    """The bound of a decode kernel (fused_decode, fused_decode2) on its
    inputs `a` and outputs `outs_`: its inputs and weights read and its
    outputs written once, the tower's multiply-adds on the rows with a
    weight."""
    rows = int((a[5] != 0).sum())
    w_tower = 2 * ROW_MACS + 4 * (4 * 256 + 1)
    return bound(nbytes(*a[1:6]) + w_tower + nbytes(*outs_),
                 2 * rows * ROW_MACS)


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


def device_rows(fn, iters: int = 1, need=(), passes: int = 5):
    """[(device ms, launches, kernel name)], largest first, of `iters`
    warm calls of `fn` under torch.profiler. A pass that sees no device
    time, or no kernel whose name holds each of `need`, is made again, up
    to `passes` passes: now and then a pass of the profiler reports no
    device activity at all (seen once on an H100 in the march phase), and
    the next pass does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for k in range(passes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        missing = [n for n in need
                   if not any(n in key and ms > 0 for ms, _, key in rows)]
        if sum(r[0] for r in rows) > 0 and not missing:
            return rows
        log(f"profiler pass {k + 1} of {passes} saw no device time for "
            f"{missing or 'any kernel'}")
    return rows


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
    over `iters` calls of `fn` under torch.profiler; None for a name the
    profiler saw in none of its passes (`device_rows`), which the callers
    print as not measured. These readings split a wrapper's time by kernel
    and are no check: the wrapper's own time is taken with CUDA events."""
    rows = device_rows(fn, iters, need=names)
    out = {n: ms / count for ms, count, key in rows for n in names
           if n in key and count and ms > 0}
    return {n: out.get(n) for n in names}


def ms_text(ms, digits: int = 3) -> str:
    """A device time that may not have been measured (None)."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


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


def tower_check(name, kern, plain, a, k):
    """Hold a tower kernel (`kern`) to its plain version on inputs (a, k):
    aw within ATOL + SIG_RTOL |aw|, hw within HW_ATOL + HW_RTOL |hw| and
    mean |diff| <= HW_MEAN_RTOL mean |hw|, the mean over both < MEAN_TOL.
    Returns the largest |diff|."""
    import torch
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


def same_step(what, a, b):
    """Fail unless two train steps (aux, tensors, launches) agree bit for
    bit: the loss and every gradient and updated weight tensor."""
    import torch
    if float(a[0]["total"]) != float(b[0]["total"]):
        fail(f"train: {what}: loss {float(a[0]['total'])!r} against "
             f"{float(b[0]['total'])!r}")
    bad = [i for i, (x, y) in enumerate(zip(a[1], b[1]))
           if not torch.equal(x, y)]
    if bad:
        fail(f"train: {what}: {len(bad)} of {len(a[1])} gradient and "
             f"weight tensors differ")
    log(f"train: {what}: loss {float(a[0]['total']):.9g} and all "
        f"{len(a[1])} gradient and updated weight tensors bit-equal")


def check_launches(path: str, got: dict, want: dict) -> None:
    """Fail unless each kernel of `want` was launched exactly that often
    on `path` (0: not at all)."""
    for name, n in want.items():
        if got.get(name, 0) != n:
            fail(f"{path}: kernel {name} launched {got.get(name, 0)} times, "
                 f"expected {n}")


def front_end_phases(c) -> dict:
    """The reference's default frame front-ends on the scene and cache of
    the first phase: the march frame, `march_rays` against its plain
    version, the raster frame, `render_frame` with and without `raster=`,
    and the four routes' frame times in turns. `c` carries main's scene,
    cache, config, rays and first-phase frame. Returns the march kernel's
    record fields, the launch counts by path and the frame times."""
    import torch
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import march as mr

    scene, cache, cfg, dev = c.scene, c.cache, c.cfg, c.dev
    q = cfg.query
    D = q.z_depth_dim
    cap = min(q.SR, q.ray_slot_budget or min(q.SR, 32), D)
    near, far = float(scene.near), float(scene.far)
    n_chunks, total = c.n_chunks, c.total
    perm_t = torch.as_tensor(c.perm, device=dev)
    fields = ("coarse_raycolor", "ray_mask", "acc", "depth")

    def sl(i):
        return slice(i * CHUNK, (i + 1) * CHUNK)

    def render(rays, cf, premarch=None):
        return fr.fast_render_rays(
            scene.params, scene.cloud.Rw2c, cache, scene.campos,
            scene.camrotc2w, rays, scene.near, scene.far, cf, c.rmin, c.svs,
            premarch=premarch)

    def chunks(cf, table=None):
        """The frame in main's shuffled ray order, 65,536 rays a chunk;
        with `table`, each chunk takes its rows of the raster's emit."""
        return [render(c.raydirs[sl(i)], cf,
                       None if table is None else (table, perm_t[sl(i)]))
                for i in range(n_chunks)]

    def frame_of(outs):
        return {f: torch.cat([getattr(o, f) for o in outs]) for f in fields}

    def counters(path, outs, names):
        ctr = {f: [None if getattr(o, f) is None else int(getattr(o, f))
                   for o in outs] for f in names}
        log(f"{path}: counters per chunk {ctr}")
        if any(v for vals in ctr.values() for v in vals):
            fail(f"{path}: non-zero exactness counter: {ctr}")
        return ctr

    def same_frame(path, a, b, other):
        for f in fields:
            if not torch.equal(a[f], b[f]):
                d = (a[f].float() - b[f].float()).abs()
                fail(f"{path}: {f} differs from the {other} frame on "
                     f"{int((a[f] != b[f]).sum())} entries, max |diff| "
                     f"{float(d.max()):.3e}")
        log(f"{path}: colour, ray_mask, acc and depth equal the {other} "
            f"frame bit for bit ({a['ray_mask'].shape[0]} rays)")

    # ---- the march table and the host plan (bench.py's sizing: the whole
    # frame in render order, buckets at the worst chunk's active count)
    t0 = time.perf_counter()
    cache.march_table = mr.build_march_table(cache.coor_2_qslot)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    table_np = cache.march_table.cpu().numpy()
    geo = tuple(x.cpu().numpy() for x in (c.rmin, c.svs, scene.campos))
    rays_np = c.raydirs.cpu().numpy()
    t0 = time.perf_counter()
    steps, buckets = mr.plan_march(
        table_np, *geo, rays_np, near, far, D, cap, slack=1.35, chunk=CHUNK,
        fuel_margin=10)
    sim = mr.simulate_march(table_np, *geo, rays_np, near, far, D, cap)
    log(f"march: table {tuple(table_np.shape)} built in {t_table:.2f} s; "
        f"plan march_steps {steps} march_buckets {buckets} (cap {cap}, "
        f"slack 1.35, chunk {CHUNK}, fuel margin 10); simulate_march: "
        f"{int(sim.sum())} steps over {int((sim > 0).sum())} walking rays "
        f"of {total}, most {int(sim.max())} a ray; planned on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg_m = dataclasses.replace(cfg, query=dataclasses.replace(
        q, march_steps=steps, march_buckets=buckets, depth_window=0))

    # ---- the march frame: the main path of this front-end, launches
    # counted from 0
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    outs_m = chunks(cfg_m)
    torch.cuda.synchronize()
    launches_m = dict(_cuda.LAUNCHES)
    log(f"march frame rendered (first pass) in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches_m}")
    check_launches("march frame", launches_m, {
        "march_rays": len(steps) * n_chunks, "fused_chunk_decode": n_chunks,
        "first_valid_cols": 0})
    counters("march frame", outs_m,
             ("mc_overflow", "rb_overflow", "cb_overflow"))
    if any(o.dw_overflow is not None for o in outs_m):
        fail("march frame: a dw_overflow counter on the march path")
    frame_dw, frame_m = frame_of(c.outs), frame_of(outs_m)
    same_frame("march frame", frame_m, frame_dw, "depth-window")

    # ---- march_rays against its plain version on chunk 0's inputs (the
    # chunk's packed rays and their live mask, as fast_render_rays makes
    # them), as planned and with the fuel cut to a third and the buckets to
    # a quarter (rays out of fuel, rays that fit no bucket); both versions
    # count each ray's iterations (count_steps)
    def march_kw(rays, **over):
        kw = fr.march_args(cache, scene.campos, rays, scene.near, scene.far,
                           cfg_m.query, c.rmin, c.svs)
        return {**kw, **over}

    ray_ids0, live0_t, _ = fr.pack_hit_rays(
        cache, scene.campos, c.raydirs[sl(0)], scene.near, scene.far,
        cfg_m.query, c.rmin, c.svs)
    m_kw = march_kw(c.raydirs[sl(0)][ray_ids0], live=live0_t)
    rays0 = m_kw["raydirs"]
    R0 = rays0.shape[0]

    def walk(fn, st, bk):
        return fn(**{**m_kw, "steps": st, "buckets": bk}, count_steps=True)

    starved = (tuple(max(1, t // 3) for t in steps),
               tuple(b // 4 for b in buckets))
    for name, (st, bk) in (("planned", (steps, buckets)),
                           ("starved", starved)):
        got = walk(mr.march_rays, st, bk)
        want = walk(mr.march_rays_reference, st, bk)
        torch.cuda.synchronize()
        for what, g, w in zip(("emit", "cnt", "mc_overflow", "steps"), got,
                              want):
            if not torch.equal(g, w):
                fail(f"march_rays ({name}) differs from its plain version: "
                     f"{what} on {int((g != w).sum())} entries")
        lanes = torch.arange(cap, device=dev)[None] >= got[1][:, None]
        if bool((got[0][lanes] != 0).any()):
            fail(f"march_rays ({name}): emit lanes past cnt are not 0")
        of = int(got[2])
        log(f"march_rays == plain ({name}: steps {st} buckets {bk}) on "
            f"{R0} rays: emit, cnt, mc_overflow {of} and "
            f"{int(got[3].sum())} iterations equal")
        if (of > 0) != (name == "starved"):
            fail(f"march_rays ({name}): mc_overflow {of}")
        if name == "planned":
            used = got[3]
    # the kernel's iterations against the host simulation with its slab
    # test in float32, as the walk's is: equal on every ray. The planner's
    # own slab test runs in float64 (simulate_march's docstring), so its
    # count may differ on a few rays; that difference is logged, and the
    # plan's fuel margin covers it
    live0 = live0_t.cpu().numpy()

    def sim_of(rays, live=None):
        out = [mr.simulate_march(table_np, *geo, rays, near, far, D, cap,
                                 slab_f32=f) for f in (True, False)]
        if live is not None:
            for s_ in out:
                s_[~live] = 0
        return out

    def hold_steps(what, used_np, sim32, sim64):
        bad = int((used_np != sim32).sum())
        if bad:
            fail(f"{what}: the kernel's iterations differ from "
                 f"simulate_march (float32 slab test) on {bad} rays, by up "
                 f"to {int(np.abs(used_np - sim32).max())}")
        off = np.abs(used_np - sim64)
        log(f"{what}: the kernel's iterations (its count_steps output) "
            f"equal simulate_march's with the slab test in float32 on every "
            f"ray: {int(used_np.sum())} steps, {int((used_np > 0).sum())} "
            f"walking rays, most {int(used_np.max())}; the planner's "
            f"float64 slab test gives {int(sim64.sum())} steps and differs "
            f"on {int((off > 0).sum())} rays, by at most {int(off.max())}")

    used_np = used.cpu().numpy()
    n_steps = int(used_np.sum())
    hold_steps("march_rays on chunk 0", used_np,
               *sim_of(rays0.cpu().numpy(), live0))

    # ---- march_rays' times at the main path's shapes. A stage's kernel
    # runs shorter than the wrapper takes on the host (a few hundred
    # microseconds of torch calls a chunk), so a few calls are queued
    # behind a busy device, few enough that the host has enqueued them all
    # before the device is free; a stage's time is the difference of the
    # walks cut after it and before it. The stage kernels alone, without
    # the wrapper's prefix counts and output ops, are read by the profiler
    def call(st=steps, bk=buckets):
        return mr.march_rays(**{**m_kw, "steps": st, "buckets": bk})

    t_m_host = cuda_ms(call, 20, 2)
    t_m = cuda_ms(call, 5, 2, queued=True)
    stage_ms, prev = [], 0.0
    for i in range(len(steps)):
        t = cuda_ms(lambda: call(steps[:i + 1], buckets[:i]), 5, 2,
                    queued=True)
        stage_ms.append(t - prev)
        prev = t
    t_m_launch = device_kernel_ms(call, ["march_stage_kernel"])[
        "march_stage_kernel"]
    t_m_kernel = None if t_m_launch is None else t_m_launch * len(steps)
    t_m_plain = cuda_ms(lambda: mr.march_rays_reference(**m_kw), 1, 1)
    # the least the card could take, by the bytes the function needs: 4 B
    # of the table for each step taken (no more than the whole table: what
    # is read twice is read once), the rays and the live mask read once,
    # emit and cnt written once. What this kernel asks of the memory system
    # is more, one 32-byte sector for each step's gather, and stands beside
    # the bound, not in it. The walk is a chain of dependent gathers and
    # IEEE divides per ray, so it is bound by latency, not by either count
    m_table = min(4 * n_steps, 4 * table_np.size)
    m_bytes = m_table + R0 * (12 + 1) + R0 * cap * 4 + R0 * 4
    m_sector_bytes = 32 * n_steps
    b_m = bound(m_bytes, 0)
    log(f"march_rays {R0} rays, {len(steps)} stages a chunk: "
        f"{t_m:.4f} ms a chunk queued behind a busy device (stages "
        f"{[round(t, 4) for t in stage_ms]}; its {len(steps)} kernels alone "
        f"by the profiler {ms_text(t_m_kernel, 4)}), {t_m_host:.4f} ms at the "
        f"host's pace; plain {t_m_plain:.2f} ms; bound {b_m[0]:.4f} ms by "
        f"{b_m[1]} ({m_table} B of the table at 4 B a step + {R0 * 13} B "
        f"of rays and live + {R0 * (cap + 1) * 4} B of emit and cnt = "
        f"{m_bytes} B), kernel / bound {t_m / b_m[0]:.2f}; its gathers ask "
        f"for {n_steps} sectors of 32 B = {m_sector_bytes} B, "
        f"{m_sector_bytes / PEAK_BYTES * 1e3:.4f} ms at the memory "
        f"rate if none were shared or cached; latency-bound on each ray's "
        f"chain of dependent gathers and divides")

    # ---- the raster: ladder measured on this camera, one emit program a
    # frame; its table against the march's on every ray of the frame
    raster = (H, W, FOCAL)
    pc = {}

    def emit_frame():
        return fr.frame_raster_emit(
            cache, scene.campos, scene.camrotc2w, c.raydirs_frame, near, far,
            cfg_m.query, c.rmin, c.svs, raster, pc)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emit_tbl, (classes, budgets_r, rows_r) = emit_frame()
    torch.cuda.synchronize()
    log(f"raster: footprint ladder {classes} budgets {budgets_r}: {rows_r} "
        f"static rows; emit table {tuple(emit_tbl.shape)} with its four "
        f"counters zero, first pass {time.perf_counter() - t0:.2f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated()} B")
    em, cn, us = [], [], []
    for i in range(n_chunks):
        e, k, of, u = mr.march_rays(
            **march_kw(c.raydirs_frame[sl(i)], steps=(2 * D + 8,),
                       buckets=()), count_steps=True)
        if int(of):
            fail(f"march over the frame's rays: mc_overflow {int(of)}")
        em.append(e)
        cn.append(k)
        us.append(u)
    em, cn = torch.cat(em), torch.cat(cn)
    hold_steps(f"march over the frame's {total} rays in one stage",
               torch.cat(us).cpu().numpy(),
               *sim_of(c.raydirs_frame.cpu().numpy()))
    if not (torch.equal(emit_tbl, em)
            and torch.equal((emit_tbl != 0).sum(-1).to(cn.dtype), cn)):
        fail(f"raster emit differs from the march's on "
             f"{int((emit_tbl != em).any(-1).sum())} of {total} rays")
    log(f"raster emit == march emit on all {total} rays "
        f"({int(cn.sum())} samples, {int((cn > 0).sum())} rays with one)")
    del em

    def raster_frame():
        return chunks(cfg_m, emit_frame()[0])

    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    outs_r = raster_frame()
    torch.cuda.synchronize()
    launches_r = dict(_cuda.LAUNCHES)
    log(f"raster frame rendered in {time.perf_counter() - t0:.2f} s; "
        f"launches {launches_r}")
    check_launches("raster frame", launches_r, {
        "fused_chunk_decode": n_chunks, "march_rays": 0,
        "first_valid_cols": 0})
    counters("raster frame", outs_r, ("rb_overflow", "cb_overflow"))
    if any(o.mc_overflow is not None for o in outs_r):
        fail("raster frame: the walk ran behind the raster's table")
    same_frame("raster frame", frame_of(outs_r), frame_m, "march")

    # ---- render_frame: rays sorted on the host, dense chunks, the budget
    # escalation; the march planned for its chunks (the frame's rays in its
    # order), once walked and once through the raster
    host_rays = c.raydirs_frame.cpu().numpy()
    dims = tuple(cache.coor_2_qslot.shape)
    order, n_hit, _ = fr.frame_ray_order(geo[2], host_rays, near, far, D,
                                         c.rmin, dims, c.svs)
    n_used = -(-n_hit // CHUNK) * CHUNK
    if n_used > total:
        order = np.concatenate([order, order[total - (n_used - total):]])
    steps_f, buckets_f = mr.plan_march(
        table_np, *geo, host_rays[order[:n_used]], near, far, D, cap,
        slack=1.35, chunk=CHUNK, fuel_margin=10)
    cfg_f = dataclasses.replace(cfg, query=dataclasses.replace(
        q, march_steps=steps_f, march_buckets=buckets_f, depth_window=0,
        ray_budget=0))
    log(f"render_frame: {n_hit} hitting rays in {n_used // CHUNK} chunks of "
        f"{CHUNK}; plan march_steps {steps_f} march_buckets {buckets_f}")

    def frame(r):
        return fr.render_frame(
            scene.params, scene.cloud.Rw2c, cache, scene.campos,
            scene.camrotc2w, c.raydirs_frame, scene.near, scene.far, cfg_f,
            c.rmin, c.svs, chunk=CHUNK, raster=r, program_cache=pc,
            host_rays=host_rays)

    frames_f, launches_f = {}, {}
    for name, r in (("march", None), ("raster", raster)):
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = frame(r)
        torch.cuda.synchronize()
        got = launches_f[name] = dict(_cuda.LAUNCHES)
        log(f"render_frame(raster={r}) rendered through the {out.front_end} "
            f"front-end in {time.perf_counter() - t0:.2f} s; launches {got}")
        if out.front_end != name:
            fail(f"render_frame(raster={r}) went through {out.front_end}")
        n_fc = got.get("fused_chunk_decode", 0)
        if n_fc < n_used // CHUNK:
            fail(f"render_frame: {n_fc} chunk launches")
        check_launches(f"render_frame {name}", got, {
            "march_rays": len(steps_f) * n_fc if r is None else 0,
            "first_valid_cols": 0})
        counters(f"render_frame {name}", [out],
                 ("mc_overflow", "cb_overflow", "dw_overflow", "rb_overflow"))
        frames_f[name] = {f: getattr(out, f) for f in fields}
    same_frame("render_frame raster", frames_f["raster"], frames_f["march"],
               "render_frame walked")
    # against the march frame, brought back to pixel order: rays are
    # independent, so the frame-level order should change no bit
    frame_m_px = {}
    for f in fields:
        frame_m_px[f] = torch.empty_like(frame_m[f])
        frame_m_px[f][perm_t] = frame_m[f]
    same_frame("render_frame", frames_f["march"], frame_m_px, "march")

    # ---- times: the four front-end routes in turns inside this run
    qv = pc[("raster_qvox", id(cache))]
    prog = next(v for k, v in pc.items() if k[0] == "raster_prog")
    near_t, step_t = m_kw["near"], m_kw["step_t"]
    t_prog = cuda_ms(lambda: prog(qv, c.rmin, c.svs, scene.campos,
                                  scene.camrotc2w, c.raydirs_frame, near_t,
                                  step_t), 3, 1)
    t_emit = cuda_ms(emit_frame, 3, 1)
    routes = {"depth_window": lambda: chunks(cfg),
              "march": lambda: chunks(cfg_m), "raster": raster_frame,
              "render_frame": lambda: frame(None),
              "render_frame_raster": lambda: frame(raster)}
    times = {name: [] for name in routes}
    for _ in range(3):
        for name, fn in routes.items():
            times[name].append(cuda_ms(fn, 1, 0))
    log(f"raster emit program {t_prog:.2f} ms; with the footprint pull and "
        f"the ladder on the host {t_emit:.2f} ms ({c.smi})")
    for name, ts in times.items():
        log(f"front-end {name}: full frame {total} rays "
            f"{[round(t, 2) for t in ts]} ms -> "
            f"{total / min(ts) * 1e3:.1f} rays/s (best of 3, in turns; "
            f"{c.smi})")
    if c.prof_dir:
        profile_pass("march", routes["march"], min(times["march"]),
                     c.prof_dir)
        profile_pass("raster", raster_frame, min(times["raster"]),
                     c.prof_dir)
    return {
        "record": dict(n=launches_m["march_rays"], err=0.0, ms=t_m,
                       plain_ms=t_m_plain, bnd=b_m,
                       extra={"pallas_kernel": False,
                              "launches_a_chunk": len(steps),
                              "stage_ms": stage_ms,
                              "device_kernels_ms": t_m_kernel,
                              "host_paced_ms": t_m_host,
                              "sectors": n_steps,
                              "sector_bytes": m_sector_bytes,
                              "bytes": m_bytes}),
        "launches": {"march": launches_m, "raster": launches_r,
                     "render_frame": launches_f["march"],
                     "render_frame_raster": launches_f["raster"]},
        "frame_ms": {k: min(v) for k, v in times.items()},
        "emit_program_ms": t_prog, "emit_ms": t_emit,
        "march_plan": {"steps": steps, "buckets": buckets},
    }


def rotate_payload(cache):
    """The payload mutant: each candidate's 96-byte payload row with its six
    16-byte pieces rotated by one (what an extract that deals the pieces to
    the wrong lanes hands the tower)."""
    kc = cache.kcand
    return dataclasses.replace(cache, kcand=kc.view(
        kc.shape[0], kc.shape[1], 6, 8).roll(1, 2).reshape(kc.shape))


def payload_phase(c) -> dict:
    """The frame check that depends on the payload: the tower's payload
    inputs scaled by PAYLOAD_SCALE (mlp_base layer 0's emb and PE(emb)
    columns, mlp_head layer 0's colour, dir-difference and dot columns),
    chunks 0-1 of the frame through the fused-chunk kernels, the staged
    kernels and the plain versions, held together at ATOL / MEAN_TOL; the
    plain route on the rotated payload must fail that bound, with these
    weights, and its difference under the scene's own weights is printed
    beside it."""
    import copy

    import torch
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.ops.fused_chunk import (
        fused_chunk_decode_plain)

    scene, cache, cfg = c.scene, c.cache, c.cfg
    rays = c.raydirs[:2 * CHUNK]
    params = copy.deepcopy(scene.params)
    with torch.no_grad():
        params.mlp_base[0].weight[:, :224] *= PAYLOAD_SCALE
        params.mlp_head[0].weight[:, 256:263] *= PAYLOAD_SCALE
    cfg_a = dataclasses.replace(
        cfg, query=dataclasses.replace(cfg.query, knn_mode="fused",
                                       chunk_mode="xla"),
        agg=dataclasses.replace(cfg.agg, fused_decode2=True))
    cfg_p = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, select_mode="topk"))

    def frame(p, cf, ca=cache, plain=False):
        orig = fr.fused_chunk_decode
        if plain:
            fr.fused_chunk_decode = fused_chunk_decode_plain
        try:
            outs = [fr.fast_render_rays(
                p, scene.cloud.Rw2c, ca, scene.campos, scene.camrotc2w,
                rays[i * CHUNK:(i + 1) * CHUNK], scene.near, scene.far, cf,
                c.rmin, c.svs) for i in range(2)]
        finally:
            fr.fused_chunk_decode = orig
        return (torch.cat([o.coarse_raycolor for o in outs]),
                torch.cat([o.ray_mask for o in outs]))

    def diff(a, b):
        d = (a[0] - b[0]).abs()
        return float(d.max()), float(d.mean())

    fused, staged, plain = (frame(params, cfg), frame(params, cfg_a),
                            frame(params, cfg_p, plain=True))
    mutant_cache = rotate_payload(cache)
    mutant = frame(params, cfg_p, mutant_cache, plain=True)
    mutant0 = frame(scene.params, cfg_p, mutant_cache, plain=True)
    plain0 = frame(scene.params, cfg_p, plain=True)
    del mutant_cache
    out = {"fused_vs_plain": diff(fused, plain),
           "staged_vs_plain": diff(staged, plain),
           "mutant_vs_fused": diff(mutant, fused),
           "mutant_vs_plain_scene_weights": diff(mutant0, plain0)}
    log(f"payload check ({2 * CHUNK} rays, payload inputs x{PAYLOAD_SCALE}): "
        + ", ".join(f"{k} max |diff| {v[0]:.3e} mean {v[1]:.3e}"
                    for k, v in out.items())
        + f"; bound {ATOL} / mean {MEAN_TOL}")
    for name in ("fused_vs_plain", "staged_vs_plain"):
        if not (torch.equal(fused[1], plain[1]) and torch.equal(staged[1],
                                                                plain[1])):
            fail("payload check: ray_mask differs between the routes")
        mx, mn = out[name]
        if not (mx <= ATOL and mn < MEAN_TOL):
            fail(f"payload check: {name} outside the bound")
    if out["mutant_vs_fused"][0] <= ATOL and out["mutant_vs_fused"][1] < \
            MEAN_TOL:
        fail("payload check: the rotated payload passes the frame check")
    return out


def orbit_pose(az_deg: float):
    """c2w [4, 4] of a camera on the chair's blender ring (radius 4.031,
    elevation 30 degrees) at azimuth `az_deg`, looking at the origin, as
    `make_chair_scene` places its camera (azimuth 30)."""
    radius, el, az = 4.0311289, np.deg2rad(30.0), np.deg2rad(az_deg)
    campos = radius * np.array([np.cos(el) * np.sin(az),
                                -np.cos(el) * np.cos(az), np.sin(el)])
    fwd = -campos / np.linalg.norm(campos)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], -1)
    pose[:3, 3] = campos
    return pose


def train_phases(c) -> dict:
    """The train path at full width (section "Train phase" of the module
    docstring). Returns the kernels' train records, it/s and the checks'
    numbers."""
    import torch
    from pointnerf2studio_torch.config import TrainConfig
    from pointnerf2studio_torch.data.blender import BlenderDataset
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.models import neural_points as npm
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import march as mr
    from pointnerf2studio_torch.ops import select as sl
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.loss import compute_losses, masked_psnr
    from pointnerf2studio_torch.train.trainer import (
        apply_updates, create_train_state)

    scene, dev, grid = c.scene, c.dev, c.scene.grid
    q = c.cfg.query
    B, D = TRAIN_RAYS, q.z_depth_dim
    # ---- the data: 4 views of one constant colour on the chair's ring
    poses = np.stack([orbit_pose(30.0 + 90.0 * v) for v in range(4)])
    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    ds = BlenderDataset(
        images=np.broadcast_to(np.asarray(TRAIN_COLOUR, np.float32),
                               (4, H, W, 3)).copy(),
        poses=poses, intrinsics=intr, near=scene.near, far=scene.far,
        split="train")
    # ray budget: the views' largest share of box-hitting rays (train
    # margin) of a 4096-ray batch, with 10% and 128 rays of slack
    hit = max(float(fr.slab_hit_mask(
        ds.campos(v), ds.full_image_rays(v), scene.near, scene.far, D,
        grid.ranges_min, grid.dims, q.scaled_vsize, jitter=0.3).mean())
        for v in range(4))
    rb = min(B, (int(hit * B * 1.1) + 128 + 255) // 256 * 256)
    cfg_d = dataclasses.replace(
        c.cfg, query=dataclasses.replace(
            q, depth_window=0, ray_budget=rb, select_mode="pallas"),
        train=TrainConfig(rays_per_batch=B, jitter=0.3, lr_fields=5e-4,
                          lr_points=2e-3, zero_one_loss_weight=1e-4,
                          fast_path=True, device_sampling=True,
                          prune_iter=0, prob_freq=0))
    t0 = time.perf_counter()
    cfg_m = loop.plan_train_march(dataclasses.replace(cfg_d, train=(
        dataclasses.replace(cfg_d.train, march_auto=True))), ds, grid)
    t_plan = time.perf_counter() - t0
    steps = cfg_m.query.march_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geo, rmin, svs = ft.make_geo_scene(cfg_m, scene.cloud, grid)
    torch.cuda.synchronize()
    t_geo = time.perf_counter() - t0
    geo_bytes = nbytes(geo.meta, geo.rel, geo.coor_2_qslot, geo.march_table)
    log(f"train: 4 views {H}x{W} of colour {TRAIN_COLOUR}, {B} rays a step, "
        f"views' box-hit share {hit:.4f} -> ray_budget {rb}; geo cache "
        f"meta {tuple(geo.meta.shape)} + rel {tuple(geo.rel.shape)} + qslot "
        f"and march tables = {geo_bytes} B built in {t_geo:.2f} s; march "
        f"plan steps {steps} buckets {cfg_m.query.march_buckets} in "
        f"{t_plan:.2f} s on the host")
    near = torch.tensor(scene.near, device=dev)
    far = torch.tensor(scene.far, device=dev)

    # ---- one fixed batch and jitter: kernel step == plain step, twice the
    # same, march == dense, all bit for bit (updated weights and gradients)
    gen = torch.Generator(device=dev).manual_seed(11)
    batch = loop.DeviceSampler(ds, B, gen).next_batch()[:4]
    u = torch.rand((B, D), generator=gen, device=dev)
    captured = {}

    def one_step(cf, plain=False):
        if plain:
            cf = dataclasses.replace(cf, query=dataclasses.replace(
                cf.query, select_mode="topk"))
        st = create_train_state(scene.params, scene.cloud, cf)
        fn = ft.make_fast_train_step(cf)
        orig_sel, orig_m = ft.select_first_cols, ft.march_rays

        def cap_sel(*a):
            captured.setdefault("qs", a[0])
            return orig_sel(*a)

        def cap_m(*a, **k):
            captured.setdefault("march", (a, k))
            return orig_m(*a, **k)

        ft.select_first_cols, ft.march_rays = cap_sel, cap_m
        if plain:
            ft.march_rays = mr.march_rays_reference
        _cuda.LAUNCHES.clear()
        try:
            st, aux = fn(st, geo, rmin, svs, *batch, near, far, jitter_u=u)
        finally:
            ft.select_first_cols, ft.march_rays = orig_sel, orig_m
        torch.cuda.synchronize()
        pts = list(st.points.trainable().values())
        ten = [p.grad for p in st.params.parameters()] + [p.grad for p in pts]
        ten += [p.detach() for p in st.params.parameters()] + pts
        return aux, ten, dict(_cuda.LAUNCHES)

    dense_k = one_step(cfg_d)
    dense_k2 = one_step(cfg_d)
    dense_p = one_step(cfg_d, plain=True)
    march_k = one_step(cfg_m)
    march_p = one_step(cfg_m, plain=True)
    for name, s_, want in (("dense", dense_k, {"first_valid_cols": 1,
                                               "march_rays": 0}),
                           ("march", march_k, {"first_valid_cols": 0,
                                               "march_rays": len(steps)}),
                           ("dense plain", dense_p, {"first_valid_cols": 0}),
                           ("march plain", march_p, {"march_rays": 0})):
        check_launches(f"train step ({name})", s_[2], want)
        for k in ("rb_overflow", "mc_overflow"):
            if k in s_[0] and float(s_[0][k]) != 0:
                fail(f"train step ({name}): {k} {float(s_[0][k])}")
    if "mc_overflow" not in march_k[0] or "rb_overflow" not in dense_k[0]:
        fail("train: a counter is missing from the step's aux")
    same_step("dense kernel step vs plain step", dense_k, dense_p)
    same_step("dense kernel step run twice", dense_k, dense_k2)
    same_step("march kernel step vs plain step", march_k, march_p)
    same_step("march step vs dense step", march_k, dense_k)
    qs = captured["qs"]
    BP = min(q.ray_slot_budget or q.SR, q.SR)
    sel_k, sel_p = sl.first_valid_cols(qs, BP), \
        sl.first_valid_cols_reference(qs, BP)
    if not all(torch.equal(a, b) for a, b in zip(sel_k, sel_p)):
        fail("train: first_valid_cols differs from its plain version")
    m_a, m_k = captured["march"]
    walk_k = mr.march_rays(*m_a, **m_k)
    walk_p = mr.march_rays_reference(*m_a, **m_k)
    if not all(torch.equal(a, b) for a, b in zip(walk_k, walk_p)):
        fail("train: march_rays differs from its plain version")
    t_sel = cuda_ms(lambda: sl.first_valid_cols(qs, BP), 48, 3, queued=True)
    t_sel_p = cuda_ms(lambda: sl.first_valid_cols_reference(qs, BP), 20, 2)
    t_walk = cuda_ms(lambda: mr.march_rays(*m_a, **m_k), 5, 2, queued=True)
    t_walk_p = cuda_ms(lambda: mr.march_rays_reference(*m_a, **m_k), 1, 1)
    b_sel = bound(nbytes(qs) + qs.shape[0] * (BP + 1) * 4, 0)
    n_walk = int(mr.march_rays(*m_a, **m_k, count_steps=True)[3].sum())
    R_m, cap = rb, min(q.SR, BP, D)          # the packed rays, the lanes
    # 4 B of the table and 4 B of t_tab a step, the rays and live read
    # once, emit and cnt written once
    b_walk = bound(8 * n_walk + R_m * (12 + 1) + R_m * (cap + 1) * 4, 0)
    log(f"train: first_valid_cols == plain on qs {tuple(qs.shape)} BP {BP}: "
        f"{t_sel:.4f} ms queued, plain {t_sel_p:.4f}, bound {b_sel[0]:.4f}; "
        f"march_rays == plain on {R_m} packed rays ({n_walk} steps, t_tab "
        f"read): {t_walk:.4f} ms queued, plain {t_walk_p:.2f}, bound "
        f"{b_walk[0]:.4f} by {b_walk[1]}")

    # ---- fit(): the user's entry point, 100 steps per front-end, launches
    # counted over the whole run
    fits = {}
    for name, cf in (("dense", cfg_d), ("march", dataclasses.replace(
            cfg_d, train=dataclasses.replace(cfg_d.train,
                                             march_auto=True)))):
        # fit() resumes from a checkpoint in its out_dir and saves one at
        # its end: each run starts from an empty directory
        out_dir = f"build/train_{name}"
        shutil.rmtree(out_dir, ignore_errors=True)
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = loop.fit(cf, ds, scene.params, scene.cloud,
                       out_dir, max_steps=TRAIN_STEPS,
                       print_freq=10, seed=3, device=dev)
        torch.cuda.synchronize()
        got = dict(_cuda.LAUNCHES)
        first, last = res.log[0], res.log[-1]
        with torch.no_grad():
            out = ft.fast_train_render(
                res.state.params, res.state.points, geo, batch[0], batch[1],
                batch[2], near, far, cfg_d, rmin, svs, training=False)
            psnr = float(masked_psnr(out, batch[3]))
        ctr = {k: max(r.get(k, 0.0) for r in res.log)
               for k in ("rb_overflow", "mc_overflow")}
        fits[name] = dict(launches=got, first=first["total"],
                          last=last["total"], psnr=psnr, counters=ctr,
                          s=time.perf_counter() - t0, state=res.state,
                          totals=[r["total"] for r in res.log])
        log(f"fit {name}: {TRAIN_STEPS} steps in {fits[name]['s']:.1f} s "
            f"(geo cache and plan included); launches {got}; loss over "
            f"steps 1-10 {first['total']:.6f} (masked PSNR "
            f"{first['ray_masked_coarse_raycolor_psnr']:.2f} dB), steps "
            f"{TRAIN_STEPS - 9}-{TRAIN_STEPS} {last['total']:.6f} "
            f"({last['ray_masked_coarse_raycolor_psnr']:.2f} dB): "
            f"{first['total'] / last['total']:.1f}x; masked PSNR of the "
            f"fixed batch after training {psnr:.2f} dB; counters {ctr}")
        want = ({"first_valid_cols": TRAIN_STEPS, "march_rays": 0}
                if name == "dense" else
                {"first_valid_cols": 0,
                 "march_rays": TRAIN_STEPS * len(steps)})
        check_launches(f"fit {name}", got, want)
        if any(ctr.values()) or len(res.log) != TRAIN_STEPS // 10:
            fail(f"fit {name}: counters {ctr} or log {len(res.log)}")
        if not first["total"] >= 4.0 * last["total"]:
            fail(f"fit {name}: the loss fell {first['total']:.6f} -> "
                 f"{last['total']:.6f}, less than 4x")

    # the two front-ends take the same steps: every window's loss and the
    # trained weights bit for bit
    fs_ = [fits[k]["state"] for k in ("dense", "march")]
    w_ = [list(f.params.parameters()) + list(f.points.trainable().values())
          for f in fs_]
    if fits["dense"]["totals"] != fits["march"]["totals"] or not all(
            torch.equal(a, b) for a, b in zip(*w_)):
        fail("fit: the march run's losses or weights differ from the dense "
             "run's")
    log(f"fit: march and dense runs bit-equal: {len(w_[0])} trained tensors "
        f"and the {len(fits['dense']['totals'])} window losses")
    for f in fits.values():
        del f["state"]

    # ---- it/s: 10 warm-up steps, then 3 windows of 20, front-ends in turns
    # two variants of the dense steps for comparisons inside this call:
    # "dense_index_backward" with torch's own backward of the attribute
    # gather (an indexing: a sorted index_put_ accumulate) in place of
    # gather_rows', "dense_one_pass" with fast_chunk = M, one chunk a step
    cfg_1 = dataclasses.replace(cfg_d, query=dataclasses.replace(
        cfg_d.query, fast_chunk=rb * q.compact_budget))
    runs = {}
    for name, cf in (("dense", cfg_d), ("march", cfg_m),
                     ("dense_index_backward", cfg_d),
                     ("dense_one_pass", cfg_1)):
        g = torch.Generator(device=dev).manual_seed(5)
        runs[name] = dict(cf=cf, st=create_train_state(scene.params,
                                                       scene.cloud, cf),
                          fn=ft.make_fast_train_step(cf), g=g,
                          smp=loop.DeviceSampler(ds, B, g), ips=[],
                          ctr=torch.zeros((), device=dev),
                          index=name.endswith("index_backward"))

    def go(r, n):
        # the fast step gathers through neural_points.gather_rows
        # (gather_attrs)
        orig = npm.gather_rows
        if r["index"]:
            npm.gather_rows = lambda table, idx: table[idx]
        try:
            for _ in range(n):
                cp, cr, rd, gt, _ = r["smp"].next_batch()
                r["st"], aux = r["fn"](r["st"], geo, rmin, svs, cp, cr, rd,
                                       gt, near, far, generator=r["g"])
                r["ctr"] += (aux.get("rb_overflow", 0)
                             + aux.get("mc_overflow", 0))
        finally:
            npm.gather_rows = orig

    ips = steps_in_turns(runs, go, c.smi)
    for name, r in runs.items():
        if float(r["ctr"]):
            fail(f"train {name}: a counter was non-zero in the timed steps")

    # ---- --profile: one step per front-end, split into its forward, its
    # backward and its optimizer update
    prof = {}
    if c.prof_dir:
        for name, r in runs.items():
            if r["index"]:
                continue
            cf = r["cf"]
            cp, cr, rd, gt, _ = r["smp"].next_batch()
            st = r["st"]

            def fwd(st=st, cf=cf, cp=cp, cr=cr, rd=rd, gt=gt, g=r["g"]):
                st.zero_grad()
                return compute_losses(ft.fast_train_render(
                    st.params, st.points, geo, cp, cr, rd, near, far, cf,
                    rmin, svs, generator=g), gt, cf.train)[0]

            prof[name] = step_profile(
                f"train {name}", fwd,
                lambda st=st, cf=cf: apply_updates(st, cf), c.prof_dir)
            del prof[name]["names"]
    c.train_setup = dict(ds=ds, cfg=cfg_d, batch=batch, u=u, near=near,
                         far=far, geo=(geo, rmin, svs))
    return {
        "select": dict(launches=fits["dense"]["launches"].get(
            "first_valid_cols", 0),
                       per_step=1, ms=t_sel, plain_ms=t_sel_p,
                       bound_ms=b_sel[0], qs=list(qs.shape)),
        "march": dict(launches=fits["march"]["launches"].get("march_rays", 0),
                      per_step=len(steps), ms=t_walk, plain_ms=t_walk_p,
                      bound_ms=b_walk[0], rays=R_m, steps=n_walk),
        "it_per_s": ips, "fit": {k: {x: v[x] for x in ("first", "last",
                                                       "psnr", "s")}
                                 for k, v in fits.items()},
        "profile": prof, "ray_budget": rb, "march_steps": steps,
        "geo_s": t_geo, "geo_bytes": geo_bytes, "plan_s": t_plan,
    }


# the routes phase: the XLA route's chunk of slots (the bench's 4,096
# would take four times the launches for the same work), the two-phase
# pipeline's decode piece, the coarse test's steps, the starting coarse
# window budget (doubled until no window is dropped) and the train
# route's steps for it/s
ROUTE_XLA_CHUNK, ROUTE_DECODE2 = 16_384, 131_072
ROUTE_COARSE_STEPS, ROUTE_WIN_BUDGET = (2, 4), 12
ROUTE_TRAIN_STEPS = 20


def routes_phase(c) -> dict:
    """The reference's opt-in render and train routes on the chair-800p
    scene, its cache and weights at full width (section "routes" of the
    module docstring). Returns the checks' numbers, each route's launches
    and frame ms, and the train routes' it/s and peak bytes."""
    import torch
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.models.aggregator import precompute_base_h
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.train.loss import compute_losses
    from pointnerf2studio_torch.train.trainer import create_train_state

    t_phase = time.perf_counter()
    scene, cache, cfg, n_chunks = c.scene, c.cache, c.cfg, c.n_chunks
    q = cfg.query
    near, far = float(scene.near), float(scene.far)
    rep = lambda cf, **kw: dataclasses.replace(  # noqa: E731
        cf, query=dataclasses.replace(cf.query, **kw))

    def frame(cf, cache_=cache):
        return [fr.fast_render_rays(
            scene.params, scene.cloud.Rw2c, cache_, scene.campos,
            scene.camrotc2w, c.raydirs[i * CHUNK:(i + 1) * CHUNK],
            scene.near, scene.far, cf, c.rmin, c.svs)
            for i in range(n_chunks)]

    def cat(outs, f):
        return torch.cat([getattr(o, f) for o in outs])

    def ctrs(outs):
        return {f: sum(int(getattr(o, f)) for o in outs)
                for f in ("win_overflow", "dw_overflow", "rb_overflow",
                          "cb_overflow", "pb_overflow")
                if getattr(outs[0], f) is not None}

    bg = torch.tensor(cfg.bg_color, device=c.dev)
    routes, launches, stats = {}, {}, {}

    def run(name, cf, cache_=cache, zero=True):
        """The route's frame once with the launches counted, checked for
        shape, finiteness, background and (zero) its counters."""
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        outs = frame(cf, cache_)
        torch.cuda.synchronize()
        launches[name] = dict(_cuda.LAUNCHES)
        col, msk = cat(outs, "coarse_raycolor"), cat(outs, "ray_mask")
        if col.shape != (c.total, 3) or not torch.isfinite(col).all():
            fail(f"routes {name}: frame colour not finite or misshapen")
        if not torch.equal(col[~msk], bg.expand(int((~msk).sum()), 3)):
            fail(f"routes {name}: miss rays are not exactly background")
        ct = ctrs(outs)
        if zero and any(ct.values()):
            fail(f"routes {name}: non-zero counter {ct}")
        routes[name] = (cf, cache_)
        stats[name] = dict(counters=ct, first_pass_s=time.perf_counter() - t0,
                           launches=launches[name])
        log(f"routes {name}: first pass {stats[name]['first_pass_s']:.2f} s, "
            f"counters {ct}, launches {launches[name]}")
        return outs

    def bit_equal(name, a, b, what):
        for f in ("coarse_raycolor", "ray_mask", "acc", "depth"):
            if not torch.equal(cat(a, f), cat(b, f)):
                d = (cat(a, f).float() - cat(b, f).float()).abs().max()
                fail(f"routes {name}: {f} differs from {what} (max |diff| "
                     f"{float(d):.3e})")
        stats[name]["held"] = f"bit-equal to {what}"
        log(f"routes {name}: colour, ray_mask, acc and depth bit-equal to "
            f"{what}")

    def near_to(name, a, b, what, atol, mean_tol, max_share=None):
        if not torch.equal(cat(a, "ray_mask"), cat(b, "ray_mask")):
            fail(f"routes {name}: ray_mask differs from {what}")
        ca, cb = cat(a, "coarse_raycolor"), cat(b, "coarse_raycolor")
        d = (ca - cb).abs()
        share = float((ca != cb).float().mean())
        stats[name].update(max_abs=float(d.max()), mean_abs=float(d.mean()),
                           share_apart=share, held=f"{what}, atol {atol}, "
                           f"mean < {mean_tol}" + (
                               f", share < {max_share}" if max_share
                               else ""))
        log(f"routes {name} vs {what}: ray_mask equal, colour max |diff| "
            f"{float(d.max()):.3e}, mean {float(d.mean()):.3e}, "
            f"{share:.2e} of the components apart")
        if not (float(d.max()) <= atol and float(d.mean()) < mean_tol
                and (max_share is None or share < max_share)):
            fail(f"routes {name}: colour outside the bound against {what}")

    # ---- the XLA route (the reference's default chunk body) and route 0
    cfg_x = rep(cfg, chunk_mode="xla", knn_mode="xla",
                fast_chunk=ROUTE_XLA_CHUNK)
    xla = run("xla", cfg_x)
    two = run("two_phase", rep(cfg_x, decode_chunk2=ROUTE_DECODE2))
    near_to("two_phase", two, xla, "the one-phase XLA frame", 1e-3, 1e-3,
            max_share=1e-3)

    # ---- route 1: chunk_mode="fused" where the whole chunk does not apply
    cfg_1a = dataclasses.replace(cfg, agg=dataclasses.replace(
        cfg.agg, fused_decode2=True))
    r1a = run("fused_mode_fused_decode2", cfg_1a)
    check_launches("routes fused_mode_fused_decode2", launches[
        "fused_mode_fused_decode2"], {
            "first_valid_cols": n_chunks, "fused_candidate_select": n_chunks,
            "fused_decode2": n_chunks, "fused_chunk_decode": 0})
    bit_equal("fused_mode_fused_decode2", r1a, c.outs_a,
              "the staged frame (knn_mode='fused', fused_decode2)")
    cfg_o1 = dataclasses.replace(cfg, agg=dataclasses.replace(
        cfg.agg, agg_intrp_order=1))
    r1b = run("fused_mode_order1", cfg_o1)
    check_launches("routes fused_mode_order1", launches["fused_mode_order1"],
                   {"first_valid_cols": n_chunks,
                    "fused_candidate_select": n_chunks, "fused_decode2": 0,
                    "fused_chunk_decode": 0})
    x1 = run("xla_order1", rep(cfg_o1, chunk_mode="xla", knn_mode="xla",
                               fast_chunk=ROUTE_XLA_CHUNK))
    near_to("fused_mode_order1", r1b, x1, "the order-1 XLA frame", ATOL,
            MEAN_TOL)

    # ---- route 2: the valid-pair decode
    K = q.K
    pair = run("pair", rep(cfg_x, decode_mode="pair", pair_budget=K))
    if pair[0].pb_overflow is not None:
        fail("routes pair: a budget of K must have no pb_overflow")
    near_to("pair", pair, xla, "the lane frame", 2e-2, 1e-3)
    _cuda.LAUNCHES.clear()
    starved = fr.fast_render_rays(
        scene.params, scene.cloud.Rw2c, cache, scene.campos, scene.camrotc2w,
        c.raydirs[:CHUNK], scene.near, scene.far,
        rep(cfg_x, decode_mode="pair", pair_budget=1, compact_budget=4),
        c.rmin, c.svs)
    pb_starved = int(starved.pb_overflow)
    stats["pair"]["pb_overflow_starved_chunk0"] = pb_starved
    log(f"routes pair: pb_overflow None at pair_budget {K} (= K), "
        f"{pb_starved} pairs dropped on chunk 0 at pair_budget 1 and "
        f"compact_budget 4")
    if pb_starved <= 0:
        fail("routes pair: a starved pair budget reported no overflow")

    # ---- route 3: krows, on the slim view of the frame's cache
    t0 = time.perf_counter()
    cache_k = dataclasses.replace(cache, slim=fr.build_slim(cache))
    torch.cuda.synchronize()
    log(f"routes krows: slim view {nbytes(cache_k.slim)} B in "
        f"{time.perf_counter() - t0:.2f} s")
    krows = run("krows", rep(cfg_x, extract_mode="krows"), cache_k)
    bit_equal("krows", krows, xla, "the onehot extract")

    # ---- route 4: base_cache, the per-point layer-1 table
    t0 = time.perf_counter()
    cache_b = dataclasses.replace(cache, base_h=precompute_base_h(
        scene.params, cfg.agg, scene.cloud.points_embeding))
    torch.cuda.synchronize()
    log(f"routes base_cache: table {tuple(cache_b.base_h.shape)} "
        f"{nbytes(cache_b.base_h)} B in {time.perf_counter() - t0:.2f} s")
    base = run("base_cache", rep(cfg_x, base_cache=True), cache_b)
    near_to("base_cache", base, xla, "the XLA frame", ATOL, MEAN_TOL)

    # ---- route 5: cand_prune, a cache of its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg_p = rep(cfg_x, cand_prune=True)
    cache_p, _, _ = fr.make_fast_scene(cfg_p, scene.cloud, scene.grid,
                                       max_q=cache.max_q)
    torch.cuda.synchronize()
    stats["prune_build_s"] = time.perf_counter() - t0
    kept = [int((cc.kmeta >= 0).sum()) for cc in (cache, cache_p)]
    log(f"routes cand_prune: width {cache.cand} -> {cache_p.cand}, "
        f"{kept[1]} of {kept[0]} candidates kept, cache built in "
        f"{stats['prune_build_s']:.2f} s")
    prune = run("cand_prune", cfg_p, cache_p)
    stats["cand_prune"].update(width=[cache.cand, cache_p.cand],
                               candidates_kept=kept)
    bit_equal("cand_prune", prune, xla, "the unpruned XLA frame")
    del cache_p

    # ---- route 6: span tiers measured on the frame, against the flat
    # window, both through the fused chunk with no compaction budget (the
    # flat frame pools M over a chunk, the tiers per tier: equal only
    # while no slot is cut, so neither cuts one, as the reference's test)
    widths, budgets = fr.measured_span_tiers(
        scene.campos, c.raydirs, near, far, q.z_depth_dim,
        scene.grid.ranges_min, scene.grid.dims, q.scaled_vsize, chunk=CHUNK)
    log(f"routes span_tiers: widths {widths} budgets {budgets} (flat "
        f"window {q.depth_window}, ray budget {q.ray_budget})")
    flat = run("flat_window", rep(cfg, compact_budget=0))
    tiers = run("span_tiers", rep(cfg, compact_budget=0, span_tiers=widths,
                                  span_tier_budgets=budgets))
    stats["span_tiers"].update(widths=list(widths), budgets=list(budgets))
    bit_equal("span_tiers", tiers, flat, "the flat-window frame")
    n_t = len(widths)
    check_launches("routes span_tiers", launches["span_tiers"], {
        "first_valid_cols": n_chunks * n_t,
        "fused_chunk_decode": n_chunks * n_t})

    # ---- route 7: the coarse test at coarse_step 2 and 4
    for S in ROUTE_COARSE_STEPS:
        name = f"coarse_step{S}"
        cfg_c = rep(cfg, coarse_step=S, coarse_win_budget=ROUTE_WIN_BUDGET)
        cache_c = dataclasses.replace(cache, coarse_occ=fr.coarse_occupancy(
            scene.grid.coor_occ, fr.coarse_dilation(cfg_c.query, near, far)))
        while True:
            probe = fr.fast_render_rays(
                scene.params, scene.cloud.Rw2c, cache_c, scene.campos,
                scene.camrotc2w, c.raydirs[:CHUNK], scene.near, scene.far,
                cfg_c, c.rmin, c.svs)
            if int(probe.win_overflow) == 0:
                break
            log(f"routes {name}: coarse_win_budget "
                f"{cfg_c.query.coarse_win_budget} dropped "
                f"{int(probe.win_overflow)} windows on chunk 0; doubling")
            cfg_c = rep(cfg_c, coarse_win_budget=2
                        * cfg_c.query.coarse_win_budget)
        co = run(name, cfg_c, cache_c)
        stats[name]["coarse_win_budget"] = cfg_c.query.coarse_win_budget
        bit_equal(name, co, c.outs, "the frame without the coarse test")

    # ---- route 8: the one-hot compaction and the grid composite
    onehot = run("onehot", rep(cfg, compact_mode="onehot"))
    check_launches("routes onehot", launches["onehot"], {
        "first_valid_cols": 0, "fused_chunk_decode": n_chunks})
    grid_c = run("grid_composite", rep(cfg, composite_mode="grid"))
    bit_equal("onehot", onehot, grid_c, "the topk compaction's frame (grid "
              "composite)")
    near_to("grid_composite", grid_c, c.outs, "the packed composite", 1e-5,
            1e-6)

    # ---- route 12: render_frame with a render_maker
    def maker(cf):
        def fn(rays, bg_c):
            return fr.fast_render_rays(
                scene.params, scene.cloud.Rw2c, cache, scene.campos,
                scene.camrotc2w, rays, scene.near, scene.far, cf, c.rmin,
                c.svs, bg_ray_colors=bg_c)
        return fn

    cfg_f = rep(cfg, depth_window=0, ray_budget=0)
    rf_args = (scene.params, scene.cloud.Rw2c, cache, scene.campos,
               scene.camrotc2w, c.raydirs_frame, scene.near, scene.far,
               cfg_f, c.rmin, c.svs)
    want_f = fr.render_frame(*rf_args)
    got_f = fr.render_frame(*rf_args, render_maker=maker)
    bit_equal_f = all(torch.equal(getattr(got_f, f), getattr(want_f, f))
                      for f in ("coarse_raycolor", "ray_mask", "acc",
                                "depth"))
    log(f"routes render_maker: render_frame through a maker that wraps "
        f"fast_render_rays {'equals' if bit_equal_f else 'differs from'} "
        f"the default frame bit for bit")
    if not bit_equal_f:
        fail("routes render_maker: frame differs from the default")

    # ---- each route's frame ms beside the XLA frame's: one warm frame
    # each, in turns (host-paced; compare inside this call only)
    frame_ms = {name: cuda_ms(lambda cf=cf, cc=cc: frame(cf, cc), 1, 0)
                for name, (cf, cc) in routes.items()}
    for name, ms in frame_ms.items():
        stats[name]["frame_ms"] = ms
        log(f"routes {name}: frame {ms:.1f} ms, {ms / frame_ms['xla']:.3f} "
            f"of the XLA route's {frame_ms['xla']:.1f} ms ({c.smi})")

    # ---- the train routes on chair-train's fixed batch
    ts = c.train_setup
    geo, grmin, gsvs = ts["geo"]
    cfg_t = ts["cfg"]

    def one_step(cf):
        st = create_train_state(scene.params, scene.cloud, cf)
        st.zero_grad()
        out = ft.fast_train_render(st.params, st.points, geo, *ts["batch"][:3],
                                   ts["near"], ts["far"], cf, grmin, gsvs,
                                   jitter_u=ts["u"])
        total, _ = compute_losses(out, ts["batch"][3], cf.train)
        total.backward()
        grads = [p.grad for p in st.params.parameters()]
        grads += [p.grad for p in st.points.trainable().values()]
        return total.item(), out, grads

    l0, o0, g0 = one_step(cfg_t)
    cfg_og = rep(cfg_t, compact_mode="onehot", composite_mode="grid")
    l1, o1, g1 = one_step(cfg_og)
    if not (torch.equal(o1.ray_mask, o0.ray_mask)
            and torch.equal(o1.pnt_mask, o0.pnt_mask)):
        fail("routes train onehot/grid: the selection differs from topk")
    d_col = (o1.coarse_raycolor - o0.coarse_raycolor).abs().max().item()
    g_rel = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                for a, b in zip(g1, g0))
    g_ok = all(torch.allclose(a, b, rtol=1e-3, atol=1e-5)
               for a, b in zip(g1, g0))
    stats["train_onehot_grid"] = dict(loss=[l0, l1], colour_max_abs=d_col,
                                      grad_max_rel=g_rel)
    log(f"routes train onehot/grid vs topk/packed: selection equal, loss "
        f"{l1!r} against {l0!r}, colour max |diff| {d_col:.3e}, largest "
        f"gradient |diff| / its leaf's max {g_rel:.3e}")
    if not (abs(l1 - l0) <= 1e-5 * abs(l0) and d_col <= 1e-5 and g_ok):
        fail("routes train onehot/grid: outside the reference's bound "
             "(loss 1e-5 relative, colour 1e-5, gradients rtol 1e-3 / "
             "atol 1e-5)")
    remat = {}
    for mode in ("selection", "full"):
        cf = dataclasses.replace(cfg_t, train=dataclasses.replace(
            cfg_t.train, remat=mode))
        lr_, _, gr_ = one_step(cf)
        if lr_ != l0 or not all(torch.equal(a, b) for a, b in zip(gr_, g0)):
            fail(f"routes train remat={mode}: loss or gradients differ "
                 f"from remat='none'")
        log(f"routes train remat={mode}: loss and all {len(g0)} gradients "
            f"bit-equal to remat='none'")
    # it/s and peak bytes of a step per remat mode, in turns
    steps_fn = {}
    for mode in ("none", "selection", "full"):
        cf = dataclasses.replace(cfg_t, train=dataclasses.replace(
            cfg_t.train, remat=mode))
        st = create_train_state(scene.params, scene.cloud, cf)
        steps_fn[mode] = (st, ft.make_fast_train_step(cf))
    peak = {m: 0 for m in steps_fn}
    secs = {m: [] for m in steps_fn}
    for rnd in range(4):
        for mode, (st, fn) in steps_fn.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_bytes = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            for _ in range(ROUTE_TRAIN_STEPS if rnd else 3):
                fn(st, geo, grmin, gsvs, *ts["batch"][:4], ts["near"],
                   ts["far"], jitter_u=ts["u"])
            torch.cuda.synchronize()
            if rnd:
                secs[mode].append(time.perf_counter() - t0)
                peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated()
                                 - base_bytes)
    for mode in steps_fn:
        ips = ROUTE_TRAIN_STEPS / sorted(secs[mode])[1]
        remat[mode] = dict(it_per_s=ips, peak_step_bytes=peak[mode])
        log(f"routes train remat={mode}: {ips:.2f} it/s (median of 3 windows "
            f"of {ROUTE_TRAIN_STEPS} steps, in turns), a step's peak "
            f"{peak[mode]} B above what was allocated before it ({c.smi})")
    del steps_fn
    stats["train_remat"] = remat
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"routes phase: {stats['phase_s']:.1f} s")
    return {"stats": stats, "launches": {f"route_{k}": v
                                         for k, v in launches.items()}}


# the probes phase: timed jittered ray sets a variant (one more for the
# warm-up) and the slots each cut-off is held to its CPU twin on
PROBE_SETS, PROBE_CPU_SLOTS = 8, 4096


def probes_phase(c) -> dict:
    """The render probes of the XLA route (`chunk_pipeline`'s and
    `fast_render_rays`' debug_ablate; pointnerf2studio_torch/tools/
    probe_stages.py) on chair-800p's scene, cache and weights, section
    "probes" of the module docstring. Returns each cut-off's ms, the
    checks' numbers and the launches of #1 and #4."""
    import copy
    import types

    import torch
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.tools import probe_stages as ps

    t_phase = time.perf_counter()
    scene, cache = c.scene, c.cache
    # the reference tools' route: the XLA candidate stages on the
    # compaction of all D samples of a ray (no depth window, no packing)
    cfg = dataclasses.replace(c.cfg, query=dataclasses.replace(
        c.cfg.query, chunk_mode="xla", knn_mode="xla", depth_window=0,
        ray_budget=0))
    cfg2 = dataclasses.replace(cfg, agg=dataclasses.replace(
        cfg.agg, fused_decode2=True))
    rays0 = c.raydirs[:CHUNK].contiguous()
    sets = ps.jittered(rays0, PROBE_SETS + 1)
    stats = {}

    # ---- the tool's compaction is what fast_render_rays' XLA route hands
    # its chunk body on chunk 0 (the slots and their geometry, bit for
    # bit), and chunk_pipeline(None) on it returns the body's outputs bit
    # for bit: both run one body, so the second is a determinism check of
    # the card's chunk, not a second implementation's parity
    seen = {}
    orig = fr._chunk_body

    def spy(*a, **k):
        out = orig(*a, **k)
        seen["args"], seen["out"] = a, out
        return out

    fr._chunk_body = spy
    try:
        fr.fast_render_rays(scene.params, scene.cloud.Rw2c, cache,
                            scene.campos, scene.camrotc2w, rays0, scene.near,
                            scene.far, cfg, c.rmin, c.svs)
    finally:
        fr._chunk_body = orig
    _cuda.LAUNCHES.clear()
    comp0 = ps.compaction(cache, cfg, scene.campos, rays0, scene.near,
                          scene.far, c.rmin, c.svs)
    direct = ps.chunk_outputs(scene, cache, cfg, c.rmin, c.svs, rays0, comp0,
                              "full")
    near, far = (torch.as_tensor(x, dtype=torch.float32,
                                 device=scene.campos.device)
                 for x in (scene.near, scene.far))
    step_t = (far - near) / cfg.query.z_depth_dim
    geom0 = fr.slot_geometry(rays0, scene.campos, near, step_t, comp0[1],
                             comp0[2], c.rmin, c.svs)
    torch.cuda.synchronize()
    # _chunk_body's (qslot_c, mask_c, rd_sel, locs, center)
    body_in = seen["args"][7:12]
    same_in = (all(torch.equal(a.long(), b.long()) for a, b in zip(
        body_in[:2], (comp0[0], comp0[3])))
        and all(torch.equal(a, b) for a, b in zip(body_in[2:], geom0)))
    same_out = all(torch.equal(a, b) for a, b in zip(seen["out"], direct))
    n_valid = int(comp0[3].sum())
    stats.update(n_valid=n_valid, live_chunks=-(-n_valid // cfg.query.fast_chunk),
                 slots=int(comp0[3].shape[0]))
    log(f"probes: chunk 0 ({CHUNK} rays, all {cfg.query.z_depth_dim} samples "
        f"looked up): {n_valid} valid slots of {comp0[3].shape[0]}, "
        f"{stats['live_chunks']} live chunks of {cfg.query.fast_chunk}; the "
        f"tool's compaction {'equals' if same_in else 'differs from'} "
        f"fast_render_rays', chunk_pipeline(None) "
        f"{'bit-equal to' if same_out else 'differs from'} its chunk body "
        f"(a determinism check: one body)")
    if not (same_in and same_out):
        fail("probes: chunk_pipeline(None) is not the XLA route's chunk body")

    # ---- each cut-off's time over the jittered sets (stages, then the
    # single-stage fakes, then full with fused_decode2), launches counted
    inputs = ps.chunk_inputs(scene, cache, cfg, c.rmin, c.svs, sets)
    torch.cuda.synchronize()
    # #1 once a compaction: chunk 0's and each set's
    launches = {"first_valid_cols": _cuda.LAUNCHES.get("first_valid_cols",
                                                       0)}
    if launches["first_valid_cols"] != PROBE_SETS + 2:
        fail(f"probes: first_valid_cols launched "
             f"{launches['first_valid_cols']} times on {PROBE_SETS + 2} "
             f"compactions")

    def plog(m):
        log(f"probes {m} ({c.smi})")

    stages = ps.probe_times("stages", scene, cache, cfg, c.rmin, c.svs,
                            inputs, log=plog)
    chunks = ps.probe_times("chunks", scene, cache, cfg, c.rmin, c.svs,
                            inputs, variants=ps.CHUNKS[:-1], log=plog)
    _cuda.LAUNCHES.clear()
    full2 = ps.probe_times("chunks", scene, cache, cfg2, c.rmin, c.svs,
                           inputs, variants=("full",),
                           log=lambda m: plog(m + " with fused_decode2"))
    torch.cuda.synchronize()
    # #4 once a live chunk of each full pipeline (the warm-up's included)
    launches["fused_decode2"] = _cuda.LAUNCHES.get("fused_decode2", 0)
    want4 = sum(-(-int(x[1][3].sum()) // cfg.query.fast_chunk)
                for x in inputs)
    if launches["fused_decode2"] != want4:
        fail(f"probes: fused_decode2 launched {launches['fused_decode2']} "
             f"times on {want4} live chunks")
    stats.update(stages_ms=stages, chunks_ms=chunks,
                 full_fused_decode2_ms=full2["full"])

    # ---- every cut-off on the card against the port's CPU run of it on
    # the first PROBE_CPU_SLOTS slots (a cache of the rows they read):
    # found and pb exactly, sigma within ATOL + SIG_RTOL |sigma|, rgb
    # within ATOL, mean |diff| over both < MEAN_TOL
    n = PROBE_CPU_SLOTS
    qs0 = comp0[0][:n]
    rows = torch.unique(torch.cat([qs0.new_zeros(1), qs0]))   # row 0: gather
    cpu_cache = fr.FatCache(
        coor_2_qslot=None, kmeta=cache.kmeta[rows].cpu(),
        kcand=cache.kcand[rows].cpu(), kxyz=cache.kxyz[rows].cpu(),
        n_q=cache.n_q.cpu())
    comp_cpu = (torch.searchsorted(rows, qs0).cpu(),
                *(x[:n].cpu() for x in comp0[1:]))
    cpu = types.SimpleNamespace(
        params=copy.deepcopy(scene.params).to("cpu"),
        cloud=types.SimpleNamespace(Rw2c=scene.cloud.Rw2c.cpu()),
        campos=scene.campos.cpu(), camrotc2w=scene.camrotc2w.cpu(),
        near=scene.near, far=scene.far)
    twins = {}
    cuts = ps.STAGES + tuple(v for v in ps.CHUNKS if v not in ps.STAGES)
    for name, cf, probe in ([(v, cfg, v) for v in cuts]
                            + [("full_fused_decode2", cfg2, "full")]):
        got = ps.chunk_outputs(scene, cache, cf, c.rmin, c.svs, rays0, comp0,
                               probe)
        want = ps.chunk_outputs(cpu, cpu_cache, cf, c.rmin.cpu(),
                                c.svs.cpu(), rays0.cpu(), comp_cpu, probe)
        sig, rgb, found, pb = (x.cpu() for x in got)
        sig, rgb, found = sig[:n], rgb[:n], found[:n]
        d_sig, d_rgb = (sig - want[0]).abs(), (rgb - want[1]).abs()
        mean = float(torch.cat([d_sig, d_rgb.reshape(-1)]).mean())
        twins[name] = dict(max_abs=float(max(d_sig.max(), d_rgb.max())),
                           mean_abs=mean)
        log(f"probes {name}: card vs CPU on the first {n} slots: found "
            f"{'equal' if torch.equal(found, want[2]) else 'DIFFERS'}, "
            f"max |diff| sigma {float(d_sig.max()):.3e} rgb "
            f"{float(d_rgb.max()):.3e}, mean {mean:.3e}")
        if not (torch.equal(found, want[2]) and int(pb) == int(want[3]) == 0
                and bool((d_sig <= ATOL + SIG_RTOL * want[0].abs()).all())
                and float(d_rgb.max()) <= ATOL and mean < MEAN_TOL):
            fail(f"probes {name}: the card's outputs disagree with the CPU's")
    stats.update(cpu_twins=twins, launches=launches,
                 phase_s=time.perf_counter() - t_phase)
    log(f"probes phase: {stats['phase_s']:.1f} s, launches {launches}")
    return stats


# ---- the widths phase: the generic kernels on chair-800p
# the two width sets: aggregator widths, K, cand_cap. narrow's renders
# take 32 features and 6 dists (the fast path's payload and every
# render's neighbour dists fix them, in the reference too); its legacy
# chunk takes 16 features, and its towers are held at 3 dists as well
WIDTH_SETS = {
    "wide": (dict(hidden_size=512, hidden_size_color=256, num_color_layers=4,
                  num_feat_freqs=4, num_dist_freqs=6, num_viewdir_freqs=5),
             16, 128),
    "narrow": (dict(hidden_size=128, hidden_size_color=64,
                    num_color_layers=2, num_feat_freqs=2, num_dist_freqs=4,
                    num_viewdir_freqs=3), 4, 32),
}
NARROW_LEGACY_FEATURES = 16


def tower_macs(C, D, H, nff, ndf) -> int:
    """Multiply-adds of the per-neighbour tower a row (the flagship's
    ROW_MACS at 32, 6, 256, 3, 5)."""
    return (C + 2 * C * nff + 2 * D * ndf) * H + H * H + (H + 7) * H \
        + H * H + H


def colour_macs(H, HC, layers, nvf) -> int:
    """Multiply-adds of the colour tower a slot (SLOT_MACS at 256, 128, 3,
    4)."""
    return (H + 6 * nvf) * HC + (layers - 1) * HC * HC + HC * 3


def kernel_ms(fn) -> float:
    """CUDA-event ms a call of `fn`; under 50 us, again with the calls
    queued behind a busy device (`cuda_ms`)."""
    t = cuda_ms(fn, 3, 1)
    return cuda_ms(fn, 20, 2, queued=True) if t < 0.05 else t


def widths_phase(c) -> dict:
    """The generic kernels on chair-800p's scene at full size and depth,
    section "widths" of the module docstring. Returns per kernel its
    launches on its path, max |diff| against its plain version, kernel,
    plain and bound ms at both width sets, and the phase's frame times
    and peak memory."""
    import torch
    from pointnerf2studio_torch.data.synthetic import _scene_params
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import fused_chunk as fc
    from pointnerf2studio_torch.ops import fused_decode as fd
    from pointnerf2studio_torch.ops import fused_select as fs

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    scene, grid = c.scene, c.scene.grid
    rays0 = c.raydirs[:CHUNK].contiguous()
    out = {"kernels": {}, "narrow": {}}

    def setup(name, **agg_extra):
        agg_kw, K, cap = WIDTH_SETS[name]
        cfg = dataclasses.replace(
            c.cfg, query=dataclasses.replace(c.cfg.query, K=K, cand_cap=cap),
            agg=dataclasses.replace(c.cfg.agg, **agg_kw, **agg_extra))
        return cfg, _scene_params(cfg, 0, c.dev)

    def render_with(cache, rmin, svs, params, cfg, rays):
        return fr.fast_render_rays(
            params, scene.cloud.Rw2c, cache, scene.campos, scene.camrotc2w,
            rays, scene.near, scene.far, cfg, rmin, svs)

    def spy(module, name, box):
        """Wrap module.name so that its first call's arguments land in
        box[name]; returns the restore function."""
        orig = getattr(module, name)

        def wrapped(*a, **k):
            box.setdefault(name, (a, k))
            box[name + "_calls"] = box.get(name + "_calls", 0) + 1
            return orig(*a, **k)

        setattr(module, name, wrapped)
        return lambda: setattr(module, name, orig)

    def counters_zero(what, outs_):
        ctr = {f: [int(getattr(o, f)) for o in outs_]
               for f in ("dw_overflow", "rb_overflow", "cb_overflow")
               if getattr(outs_[0], f) is not None}
        if any(v for vals in ctr.values() for v in vals):
            fail(f"widths {what}: non-zero exactness counter: {ctr}")
        log(f"widths {what}: exactness counters {ctr}")

    def check_chunk_pair(what, a, b):
        """Two renders of chunk 0 (one route against another): ray_mask
        equal, colour within ATOL / MEAN_TOL."""
        if not torch.equal(a.ray_mask, b.ray_mask):
            fail(f"widths {what}: ray_mask differs on "
                 f"{int((a.ray_mask != b.ray_mask).sum())} rays")
        d = (a.coarse_raycolor - b.coarse_raycolor).abs()
        log(f"widths {what}: ray_mask equal, colour max |diff| "
            f"{float(d.max()):.3e}, mean {float(d.mean()):.3e}")
        if not (float(d.max()) <= ATOL and float(d.mean()) < MEAN_TOL):
            fail(f"widths {what}: colour disagrees")

    def select_check(name, args):
        """fused_candidate_select against its plain version: pnt_mask and
        every payload bit."""
        ns_k, pm_k = fs.fused_candidate_select(*args)
        ns_p, pm_p = fs.fused_candidate_select_plain(*args)
        torch.cuda.synchronize()
        bits = int((ns_k.view(torch.int16) != ns_p.view(torch.int16)).sum())
        if not torch.equal(pm_k, pm_p) or bits:
            fail(f"widths {name}: fused_candidate_select differs from its "
                 f"plain version (pnt_mask on {int((pm_k != pm_p).sum())}, "
                 f"payload on {bits})")
        m_, n_pairs = args[5], int(pm_k.sum())
        b = bound(int(m_.sum()) * (args[0].shape[1] * 10) + n_pairs * 96
                  + m_.shape[0] * 17 + nbytes(ns_k, pm_k), 0)
        t_k = kernel_ms(lambda: fs.fused_candidate_select(*args))
        t_p = cuda_ms(lambda: fs.fused_candidate_select_plain(*args), 2, 1)
        log(f"widths {name}: fused_candidate_select (K {args[6]}, C "
            f"{args[0].shape[1]}) == plain on M={m_.shape[0]} slots "
            f"({int(m_.sum())} valid, {n_pairs} neighbours); kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {b[0]:.4f} ms by "
            f"{b[1]} ({c.smi})")
        return dict(max_abs_err=float((ns_k.float() - ns_p.float()).abs()
                                      .max()), ms=t_k, plain_ms=t_p,
                    bound_ms=b[0], bound_by=b[1], M=m_.shape[0],
                    neighbours=n_pairs)

    def tower_stats(name, entry, kern, plain, a, k, agg_cfg):
        """A decode tower held to its plain version (`tower_check`), timed,
        beside its bound at these widths."""
        err = tower_check(f"widths {name}: {entry}", kern, plain, a, k)
        C, D = a[1].shape[-1], a[2].shape[-1]
        H = agg_cfg.hidden_size
        macs = tower_macs(C, D, H, k["nff"], k["ndf"])
        rows = int((a[5] != 0).sum())
        outs_ = kern(*a, **k)
        w_bytes = 2 * macs + 4 * (4 * H + 1)
        b = bound(nbytes(*a[1:6]) + w_bytes + nbytes(*outs_),
                  2 * rows * macs)
        t_k = kernel_ms(lambda: kern(*a, **k))
        t_p = cuda_ms(lambda: plain(*a, **k), 2, 1)
        log(f"widths {name}: {entry} (C {C}, D {D}, H {H}, octaves "
            f"({k['nff']}, {k['ndf']}), K {a[1].shape[1]}) M={a[1].shape[0]}, "
            f"{rows} rows: kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
            f"{b[0]:.4f} ms by {b[1]}, kernel / bound {t_k / b[0]:.2f}, "
            f"{2 * rows * macs / t_k / 1e9:.1f} TFLOP/s of useful work "
            f"({c.smi})")
        return dict(max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b[0],
                    bound_by=b[1], M=a[1].shape[0], rows=rows)

    # =================================================================
    # wide: K 16 of C 128, hidden 512, colour 256 x 4, octaves (4, 6, 5)
    # =================================================================
    cfg_w, params_w = setup("wide")
    t0 = time.perf_counter()
    cache_w, rmin, svs = fr.make_fast_scene(cfg_w, scene.cloud, grid)
    torch.cuda.synchronize()
    log(f"widths wide: fat cache C {cache_w.cand}, kcand "
        f"{tuple(cache_w.kcand.shape)} {nbytes(cache_w.kcand)} B, kmeta "
        f"{nbytes(cache_w.kmeta)} B, kxyz {nbytes(cache_w.kxyz)} B, built "
        f"in {time.perf_counter() - t0:.1f} s; device memory allocated "
        f"{torch.cuda.memory_allocated()} B")
    if cache_w.cand != WIDTH_SETS["wide"][2]:
        fail(f"widths wide: cache width {cache_w.cand}")

    def frame_w():
        return [render_with(cache_w, rmin, svs, params_w, cfg_w,
                            c.raydirs[i * CHUNK:(i + 1) * CHUNK])
                for i in range(c.n_chunks)]

    # ---- the fused-chunk frame (#1, #5 generic), launches counted
    box = {}
    restore = spy(fr, "fused_chunk_decode", box)
    _cuda.LAUNCHES.clear()
    try:
        t0 = time.perf_counter()
        outs_w = frame_w()
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(_cuda.LAUNCHES)
    log(f"widths wide: fused-chunk frame (first pass) in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    check_launches("widths wide frame", launches, {
        "first_valid_cols": c.n_chunks, "fused_chunk_decode_any": c.n_chunks,
        "fused_chunk_decode": 0})
    counters_zero("wide frame", outs_w)
    color_w = torch.cat([o.coarse_raycolor for o in outs_w])
    mask_w = torch.cat([o.ray_mask for o in outs_w])
    if not torch.isfinite(color_w).all() or not bool(mask_w.any()):
        fail("widths wide: frame colour not finite or no ray hit")
    bg = torch.tensor(c.cfg.bg_color, device=c.dev)
    if not torch.equal(color_w[~mask_w], bg.expand(int((~mask_w).sum()), 3)):
        fail("widths wide: miss rays are not exactly background")
    out["wide_frame_launches"] = launches

    # chunk 0's fused_chunk_decode against its plain version
    args, kw = box["fused_chunk_decode"]
    sig_k, rgb_k, fnd_k = fc.fused_chunk_decode(*args, **kw)
    sig_p, rgb_p, fnd_p = fc.fused_chunk_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(fnd_k, fnd_p):
        fail(f"widths wide: fused_chunk_decode found differs on "
             f"{int((fnd_k != fnd_p).sum())} slots")
    m_sl = args[-1]
    d_sig, d_rgb = (sig_k - sig_p).abs()[m_sl], (rgb_k - rgb_p).abs()[m_sl]
    mean = float(torch.cat([d_sig, d_rgb.reshape(-1)]).mean())
    log(f"widths wide: fused_chunk_decode vs plain on M={m_sl.shape[0]} "
        f"slots ({int(m_sl.sum())} valid, {int(fnd_k.sum())} found): found "
        f"equal, max |diff| sigma {float(d_sig.max()):.3e} rgb "
        f"{float(d_rgb.max()):.3e}, mean {mean:.3e}")
    if not (bool((d_sig <= ATOL + SIG_RTOL * sig_p.abs()[m_sl]).all())
            and float(d_rgb.max()) <= ATOL and mean < MEAN_TOL):
        fail("widths wide: fused_chunk_decode disagrees with its plain "
             "version")
    # pairs with a neighbour, slots found: the towers' work on this data
    ns_w, pm_w = fs.fused_candidate_select_plain(
        args[4], args[5], args[6], args[7],
        (args[9] - args[8]).contiguous(), m_sl, kw["K"], kw["radius2"],
        kw["num_shells"])
    n_pairs, n_found = int(pm_w.sum()), int(fnd_k.sum())
    agg_w = cfg_w.agg
    rmac = tower_macs(32, 6, agg_w.hidden_size, agg_w.num_feat_freqs,
                      agg_w.num_dist_freqs)
    smac = colour_macs(agg_w.hidden_size, agg_w.hidden_size_color,
                       agg_w.num_color_layers, agg_w.num_viewdir_freqs)
    C = cache_w.cand
    b_fc = bound(int(m_sl.sum()) * C * 10 + n_pairs * 96
                 + m_sl.shape[0] * 58 + fused_chunk_weight_bytes(params_w),
                 2 * (n_pairs * rmac + n_found * smac))
    t_fc = kernel_ms(lambda: fc.fused_chunk_decode(*args, **kw))
    t_fc_p = cuda_ms(lambda: fc.fused_chunk_decode_plain(*args, **kw), 1, 1)
    log(f"widths wide: fused_chunk_decode_any M={m_sl.shape[0]}, "
        f"{n_pairs} pairs, {n_found} slots found: kernel {t_fc:.3f} ms, "
        f"plain {t_fc_p:.3f} ms, bound {b_fc[0]:.3f} ms by {b_fc[1]}, "
        f"kernel / bound {t_fc / b_fc[0]:.2f}, "
        f"{2 * (n_pairs * rmac + n_found * smac) / t_fc / 1e9:.1f} TFLOP/s "
        f"of useful work ({c.smi})")
    out["kernels"]["fused_chunk_decode_any"] = dict(
        launches=launches["fused_chunk_decode_any"],
        max_abs_err=float(max(d_sig.max(), d_rgb.max())), ms=t_fc,
        plain_ms=t_fc_p, bound_ms=b_fc[0], bound_by=b_fc[1],
        M=m_sl.shape[0], pairs=n_pairs)

    # ---- the staged chunk 0 (#1, #2 at (128, 16), #4 generic)
    cfg_ws = dataclasses.replace(
        cfg_w, query=dataclasses.replace(cfg_w.query, knn_mode="fused",
                                         chunk_mode="xla"),
        agg=dataclasses.replace(cfg_w.agg, fused_decode2=True))
    box = {}
    restores = [spy(fr, "fused_candidate_select", box),
                spy(fd, "kacc_tower", box)]
    _cuda.LAUNCHES.clear()
    try:
        out_ws = render_with(cache_w, rmin, svs, params_w, cfg_ws, rays0)
        torch.cuda.synchronize()
    finally:
        for r in restores:
            r()
    launches = dict(_cuda.LAUNCHES)
    log(f"widths wide: staged chunk 0 launches {launches}")
    check_launches("widths wide staged", launches, {
        "first_valid_cols": 1, "fused_candidate_select_any": 1,
        "fused_decode2_any": 1, "fused_candidate_select": 0,
        "fused_decode2": 0})
    counters_zero("wide staged", [out_ws])
    check_chunk_pair("wide staged chunk 0 vs the fused-chunk frame's",
                     out_ws, outs_w[0])
    st = select_check("wide", box["fused_candidate_select"][0])
    st["launches"] = launches["fused_candidate_select_any"]
    out["kernels"]["fused_candidate_select_any"] = st
    a, k = box["kacc_tower"]
    st = tower_stats("wide", "fused_decode2_any", fd.kacc_tower,
                     fd.kacc_tower_reference, a, k, cfg_w.agg)
    st["launches"] = launches["fused_decode2_any"]
    out["kernels"]["fused_decode2_any"] = st

    # ---- one legacy chunk with fused_decode (#1, #3 generic)
    cfg_wb = dataclasses.replace(cfg_w, agg=dataclasses.replace(
        cfg_w.agg, fused_decode=True))
    qb = cfg_wb.query
    m_b = min(CHUNK * (qb.compact_budget or qb.SR), CHUNK * qb.z_depth_dim)
    box = {}
    restore = spy(fd, "pair_tower", box)
    _cuda.LAUNCHES.clear()
    try:
        with torch.no_grad():
            out_wb = lr.render_rays(params_w, scene.cloud, grid, scene.campos,
                                    scene.camrotc2w, rays0, scene.near,
                                    scene.far, cfg_wb)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(_cuda.LAUNCHES)
    log(f"widths wide: legacy chunk launches {launches}")
    check_launches("widths wide legacy", launches, {
        "first_valid_cols": 1, "fused_decode_any": -(-m_b // qb.decode_chunk),
        "fused_decode": 0})
    if not torch.isfinite(out_wb.coarse_raycolor).all():
        fail("widths wide: legacy colour not finite")
    a, k = box["pair_tower"]
    st = tower_stats("wide", "fused_decode_any", fd.pair_tower,
                     fd.pair_tower_reference, a, k, cfg_w.agg)
    st["launches"] = launches["fused_decode_any"]
    out["kernels"]["fused_decode_any"] = st

    # ---- the wide frame beside the flagship frame, in turns
    def frame_main():
        return [render_with(c.cache, c.rmin, c.svs, scene.params, c.cfg,
                            c.raydirs[i * CHUNK:(i + 1) * CHUNK])
                for i in range(c.n_chunks)]

    turns = {"flagship": [], "wide": []}
    for name in ("flagship", "wide", "wide", "flagship"):
        turns[name].append(cuda_ms(frame_main if name == "flagship"
                                   else frame_w, 1))
    log(f"widths: frame ms in turns, flagship {[round(t, 2) for t in turns['flagship']]}, "
        f"wide {[round(t, 2) for t in turns['wide']]} ({c.smi})")
    out["frame_ms"] = turns
    del cache_w, outs_w, out_ws, out_wb, box, args, kw, a, k
    torch.cuda.empty_cache()

    # =================================================================
    # narrow: K 4 of C 32, hidden 128, colour 64 x 2, octaves (2, 4, 3)
    # =================================================================
    cfg_n, params_n = setup("narrow")
    cache_n, rmin, svs = fr.make_fast_scene(cfg_n, scene.cloud, grid)
    if cache_n.cand != WIDTH_SETS["narrow"][2]:
        fail(f"widths narrow: cache width {cache_n.cand}")
    # ---- the staged chunk 0 (#1, #2 tuned, #4 generic)
    cfg_ns = dataclasses.replace(
        cfg_n, query=dataclasses.replace(cfg_n.query, knn_mode="fused",
                                         chunk_mode="xla"),
        agg=dataclasses.replace(cfg_n.agg, fused_decode2=True))
    box = {}
    restores = [spy(fr, "fused_candidate_select", box),
                spy(fd, "kacc_tower", box)]
    _cuda.LAUNCHES.clear()
    try:
        out_ns = render_with(cache_n, rmin, svs, params_n, cfg_ns, rays0)
        torch.cuda.synchronize()
    finally:
        for r in restores:
            r()
    launches = dict(_cuda.LAUNCHES)
    log(f"widths narrow: staged chunk 0 launches {launches}")
    check_launches("widths narrow staged", launches, {
        "first_valid_cols": 1, "fused_candidate_select": 1,
        "fused_decode2_any": 1, "fused_candidate_select_any": 0,
        "fused_decode2": 0})
    counters_zero("narrow staged", [out_ns])
    st = select_check("narrow", box["fused_candidate_select"][0])
    out["narrow"]["fused_candidate_select"] = st
    a, k = box["kacc_tower"]
    out["narrow"]["fused_decode2_any"] = tower_stats(
        "narrow", "fused_decode2_any", fd.kacc_tower,
        fd.kacc_tower_reference, a, k, cfg_n.agg)
    out["narrow"]["staged_launches"] = launches

    # ---- the XLA route with fused_decode2 (#1, #4 generic), chunk 0
    cfg_nx = dataclasses.replace(
        cfg_n, query=dataclasses.replace(cfg_n.query, knn_mode="xla",
                                         chunk_mode="xla"),
        agg=dataclasses.replace(cfg_n.agg, fused_decode2=True))
    box = {}
    restores = [spy(fd, "kacc_tower", box), spy(fr, "_xla_route", box)]
    _cuda.LAUNCHES.clear()
    try:
        out_nx = render_with(cache_n, rmin, svs, params_n, cfg_nx, rays0)
        torch.cuda.synchronize()
    finally:
        for r in restores:
            r()
    launches = dict(_cuda.LAUNCHES)
    M_x = box["_xla_route"][0][6].shape[0]
    want4 = -(-int(out_nx.n_valid_slots) // fr.xla_chunk_slots(
        cfg_nx.query, M_x))
    log(f"widths narrow: XLA route chunk 0 launches {launches} "
        f"({int(out_nx.n_valid_slots)} valid slots of {M_x}, "
        f"{want4} live chunks)")
    check_launches("widths narrow XLA route", launches, {
        "first_valid_cols": 1, "fused_decode2_any": want4,
        "fused_decode2": 0})
    counters_zero("narrow XLA route", [out_nx])
    check_chunk_pair("narrow XLA route chunk 0 vs the staged chunk 0",
                     out_nx, out_ns)
    out["narrow"]["xla_launches"] = launches

    # ---- a legacy chunk with fused_decode at 16 features (#1, #3
    # generic); its tower again at 3 dists on the same rows
    cfg_nb, params_nb = setup(
        "narrow", point_features_dim=NARROW_LEGACY_FEATURES,
        fused_decode=True)
    cloud16 = dataclasses.replace(
        scene.cloud, points_embeding=scene.cloud.points_embeding[
            :, :NARROW_LEGACY_FEATURES].contiguous())
    qb = cfg_nb.query
    m_b = min(CHUNK * (qb.compact_budget or qb.SR), CHUNK * qb.z_depth_dim)
    box = {}
    restore = spy(fd, "pair_tower", box)
    _cuda.LAUNCHES.clear()
    try:
        with torch.no_grad():
            out_nb = lr.render_rays(params_nb, cloud16, grid, scene.campos,
                                    scene.camrotc2w, rays0, scene.near,
                                    scene.far, cfg_nb)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(_cuda.LAUNCHES)
    log(f"widths narrow: legacy chunk (16 features) launches {launches}")
    check_launches("widths narrow legacy", launches, {
        "first_valid_cols": 1, "fused_decode_any": -(-m_b // qb.decode_chunk),
        "fused_decode": 0})
    if not torch.isfinite(out_nb.coarse_raycolor).all():
        fail("widths narrow: legacy colour not finite")
    a, k = box["pair_tower"]
    out["narrow"]["fused_decode_any"] = tower_stats(
        "narrow", "fused_decode_any", fd.pair_tower,
        fd.pair_tower_reference, a, k, cfg_nb.agg)
    out["narrow"]["legacy_launches"] = launches
    cfg_n3, params_n3 = setup(
        "narrow", point_features_dim=NARROW_LEGACY_FEATURES, agg_dist_pers=0)
    a3 = (params_n3, a[1], a[2][..., :3].contiguous(), *a[3:])
    for entry, kern, plain in (
            ("fused_decode_any", fd.pair_tower, fd.pair_tower_reference),
            ("fused_decode2_any", fd.kacc_tower, fd.kacc_tower_reference)):
        n0 = _cuda.LAUNCHES[entry]
        out["narrow"][entry + "_dist3"] = tower_stats(
            "narrow, 3 dists", entry, kern, plain, a3, k, cfg_n3.agg)
        if _cuda.LAUNCHES[entry] <= n0:
            fail(f"widths narrow: {entry} was not launched at 3 dists")
    del cache_n, box, a, a3, k
    torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"widths phase: {out['phase_s']:.1f} s, peak device memory "
        f"{out['peak_bytes']} B")
    return out


LEGACY_KERNELS = ("linear", "quadric", "avg", "numlinear", "numquadric")


def legacy_phases(c) -> dict:
    """The reference's default route (section 10 of the module docstring):
    the served chunk on the grid's candidate cache, the cache route against
    the grid route, the five weight kernels through fused_decode, and the
    legacy train step and fit(fast_path=False) on the train phase's views.
    Returns the kernels' legacy records and the checks' numbers."""
    import torch
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.models import neural_points as npm
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import fused_decode as fd
    from pointnerf2studio_torch.ops import query as qy
    from pointnerf2studio_torch.ops import select as sl
    from pointnerf2studio_torch.ops.grid import build_candidate_cache
    from pointnerf2studio_torch.ops.raygen import (
        near_far_linear_ray_generation)
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.loss import compute_losses
    from pointnerf2studio_torch.train.trainer import (
        apply_updates, create_train_state, make_train_step)

    scene, dev, grid = c.scene, c.dev, c.scene.grid
    q = c.cfg.query
    max_q = c.cache.max_q
    rays0 = c.raydirs[:CHUNK]
    bg = torch.tensor(c.cfg.bg_color, device=dev)
    none_else = {"fused_chunk_decode": 0, "fused_candidate_select": 0,
                 "fused_decode2": 0, "march_rays": 0}

    def build(cap):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cc = build_candidate_cache(grid, scene.cloud.xyz, q.kernel_size,
                                   max_q, cap)
        torch.cuda.synchronize()
        return cc, time.perf_counter() - t0

    cc, t_cache = build(q.cand_cap)
    grid_c = dataclasses.replace(grid, cache=cc)
    cache_bytes = nbytes(cc.cand_pack, cc.coor_2_qslot)
    log(f"legacy: candidate cache cand_pack {tuple(cc.cand_pack.shape)} + "
        f"qslot table = {cache_bytes} B (max_q {max_q}, C {q.cand_cap}) "
        f"built in {t_cache:.2f} s")
    cfg_s = dataclasses.replace(
        c.cfg, query=dataclasses.replace(q, use_cache=True, max_q=max_q),
        agg=dataclasses.replace(c.cfg.agg, fused_decode=True))

    def served(rays, cf=cfg_s, g=grid_c):
        with torch.no_grad():
            return lr.render_rays(scene.params, scene.cloud, g, scene.campos,
                                  scene.camrotc2w, rays, scene.near,
                                  scene.far, cf)

    # ---- (a) the served chunk on the cache: the main path of this phase
    captured = {}
    orig_fvc, orig_pair = lr.first_valid_cols, fd.pair_tower

    def cap_fvc(qs_, bp_):
        captured.setdefault("fvc", (qs_, bp_))
        return orig_fvc(qs_, bp_)

    def cap_pair(*a, **k):
        captured.setdefault("pair", (a, k))
        return orig_pair(*a, **k)

    lr.first_valid_cols, fd.pair_tower = cap_fvc, cap_pair
    _cuda.LAUNCHES.clear()
    try:
        out = served(rays0)
        torch.cuda.synchronize()
    finally:
        lr.first_valid_cols, fd.pair_tower = orig_fvc, orig_pair
    got_s = dict(_cuda.LAUNCHES)
    M = CHUNK * q.compact_budget
    n_pieces = -(-M // q.decode_chunk)
    check_launches("legacy served chunk (cache)", got_s,
                   {"first_valid_cols": 1, "fused_decode": n_pieces,
                    **none_else})
    col, mask = out.coarse_raycolor, out.ray_mask
    if col.shape != (CHUNK, 3) or not torch.isfinite(col).all():
        fail("legacy served chunk: colour is not finite or misshapen")
    if not torch.equal(col[~mask], bg.expand(int((~mask).sum()), 3)):
        fail("legacy served chunk: miss rays are not exactly background")
    if not 0.05 < float(mask.float().mean()) < 0.95:
        fail("legacy served chunk: implausible ray_mask")
    qs_s, bp_s = captured["fvc"]
    if not all(torch.equal(a, b) for a, b in zip(
            sl.first_valid_cols(qs_s, bp_s),
            sl.first_valid_cols_reference(qs_s, bp_s))):
        fail("legacy: first_valid_cols differs from its plain version on "
             "the cache route's qslot table")
    pair_a, pair_k = captured["pair"]
    pair_err = tower_check("fused_decode (cache route)", fd.pair_tower,
                           fd.pair_tower_reference, pair_a, pair_k)
    lr.first_valid_cols = sl.first_valid_cols_reference
    lr.fused_decode = fd.fused_decode_reference
    try:
        out_p = served(rays0)
    finally:
        lr.first_valid_cols, lr.fused_decode = orig_fvc, fd.fused_decode
    if not torch.equal(mask, out_p.ray_mask):
        fail("legacy served chunk: ray_mask differs between kernels and plain")
    dc = (col - out_p.coarse_raycolor).abs()
    served_diff = (float(dc.max()), float(dc.mean()))
    log(f"legacy served chunk ({CHUNK} rays, cache route): launches {got_s}; "
        f"kernels vs plain: ray_mask equal, colour max |diff| "
        f"{served_diff[0]:.3e}, mean {served_diff[1]:.3e}; ray_mask fraction "
        f"{float(mask.float().mean()):.4f}")
    if not (served_diff[0] <= ATOL and served_diff[1] < MEAN_TOL):
        fail("legacy served chunk: colour through the kernels disagrees")

    # ---- the cache route against the grid route at cand_cap = V * P: the
    # same samples, the same neighbour sets
    V_P = 27 * grid.occ_2_pnts.shape[1]
    cc_full, t_full = build(V_P)
    g_full = dataclasses.replace(grid, cache=cc_full)
    D, SR, K = q.z_depth_dim, q.SR, q.K
    r2 = q.radius_limit ** 2
    with torch.no_grad():
        raypos = near_far_linear_ray_generation(
            scene.campos, rays0, D, scene.near, scene.far)[0]
        qs_c = qy.mask_raypos_qslot(g_full, raypos)
        qs_g = qy.mask_raypos(grid, raypos)
        if not torch.equal(qs_c >= 0, qs_g):
            fail("legacy: the cache's query slots and the grid's occupancy "
                 "disagree")
        sel, mask_c, _ = lr.compact_samples(qs_c, SR, M)
        locs = raypos.reshape(-1, 3)[sel]
        p_c = qy.knn_from_cache(g_full, qs_c.reshape(-1)[sel], locs, mask_c,
                                K, r2, (q.kernel_size[0] + 1) // 2,
                                layered=q.layered_search)
        p_g = qy.knn_for_locs(grid, scene.cloud.xyz, locs, mask_c, K, r2,
                              q.kernel_size, layered=q.layered_search)
    torch.cuda.synchronize()
    same_set = torch.equal(torch.sort(p_c, -1).values,
                           torch.sort(p_g, -1).values)
    in_order = int((p_c == p_g).all(-1).sum())
    log(f"legacy: cache route (cand_cap {V_P}: cand_pack "
        f"{nbytes(cc_full.cand_pack)} B built in {t_full:.2f} s) vs grid "
        f"route on {int(mask_c.sum())} slots: neighbour sets "
        f"{'bit-equal' if same_set else 'DIFFER'}, in the same order on "
        f"{in_order} of {M} slots; {int((p_c >= 0).sum())} neighbours")
    if not same_set:
        fail("legacy: the cache route's neighbours differ from the grid "
             "route's")
    del cc_full, g_full, p_c, p_g, raypos, qs_c, qs_g

    # ---- the five weight kernels of fused_decode's gate, one 8,192-ray
    # piece each through the kernels, held to their plain versions and to
    # decode_radiance in float32 (the decoder without bf16 rounding), both
    # at ATOL / MEAN_TOL; decode_radiance in bf16 is printed beside them:
    # under the count-normalised kernels (numlinear, numquadric) the weights
    # reach 1 / (8 |d|^2), and the bf16 rounding of the tower's K-sums moves
    # that decoder's colour further from the float32 one than the kernel's
    piece = rays0[:8192]
    kernels = {}
    for kind in LEGACY_KERNELS:
        cf = dataclasses.replace(cfg_s, agg=dataclasses.replace(
            cfg_s.agg, agg_distance_kernel=kind))
        _cuda.LAUNCHES.clear()
        o_k = served(piece, cf)
        torch.cuda.synchronize()
        n_k = _cuda.LAUNCHES.get("fused_decode", 0)
        lr.first_valid_cols = sl.first_valid_cols_reference
        lr.fused_decode = fd.fused_decode_reference
        try:
            o_p = served(piece, cf)
        finally:
            lr.first_valid_cols, lr.fused_decode = orig_fvc, fd.fused_decode
        o_r = {dt: served(piece, dataclasses.replace(
            cf, agg=dataclasses.replace(cf.agg, fused_decode=False,
                                        compute_dtype=dt)))
            for dt in ("float32", "bfloat16")}
        if n_k < 1 or not all(torch.equal(o_k.ray_mask, o.ray_mask)
                              for o in (o_p, *o_r.values())):
            fail(f"legacy {kind}: fused_decode launched {n_k} times or "
                 f"ray_mask differs between the routes")

        def dif(a, b):
            d = (a.coarse_raycolor - b.coarse_raycolor).abs()
            return float(d.max()), float(d.mean())

        kernels[kind] = {
            "plain": dif(o_k, o_p),
            "decode_radiance_f32": dif(o_k, o_r["float32"]),
            "decode_radiance_bf16": dif(o_k, o_r["bfloat16"]),
            "bf16_decode_radiance_vs_f32": dif(o_r["bfloat16"],
                                               o_r["float32"])}
        if not all(kernels[kind][n][0] <= ATOL
                   and kernels[kind][n][1] < MEAN_TOL
                   for n in ("plain", "decode_radiance_f32")):
            fail(f"legacy {kind}: fused_decode disagrees: {kernels[kind]}")
    log("legacy weight kernels through fused_decode (8192 rays), colour max "
        "|diff| / mean against the plain route and against decode_radiance "
        "in float32 (held), against decode_radiance in bf16 and bf16 "
        "decode_radiance against float32 (printed): " + "; ".join(
            f"{k} " + ", ".join(f"{v[0]:.3e}/{v[1]:.3e}" for v in d.values())
            for k, d in kernels.items()))

    # ---- times: the chunk with the cache and on the grid, in turns
    cfg_g = dataclasses.replace(cfg_s, query=dataclasses.replace(
        cfg_s.query, use_cache=False))
    t_c, t_g = [], []
    for _ in range(3):
        t_c.append(cuda_ms(lambda: served(rays0), 1))
        t_g.append(cuda_ms(lambda: served(rays0, cfg_g, grid), 1))
    log(f"legacy chunk {CHUNK} rays: cache route "
        f"{[round(t, 2) for t in t_c]} ms, grid route "
        f"{[round(t, 2) for t in t_g]} ms (in turns; best {min(t_c):.2f} / "
        f"{min(t_g):.2f}; {c.smi})")
    t_pt = cuda_ms(lambda: fd.pair_tower(*pair_a, **pair_k), 10, 2)
    t_pt_p = cuda_ms(lambda: fd.pair_tower_reference(*pair_a, **pair_k), 2, 1)
    b_pt = tower_bound(pair_a, fd.pair_tower(*pair_a, **pair_k))
    if c.prof_dir:
        profile_pass("legacy_cache", lambda: served(rays0), min(t_c),
                     c.prof_dir)
        profile_pass("legacy_grid", lambda: served(rays0, cfg_g, grid),
                     min(t_g), c.prof_dir)

    # ---- (b) the legacy train step on the train phase's views and batch
    ts = c.train_setup
    ds, batch, u, near, far = (ts["ds"], ts["batch"], ts["u"], ts["near"],
                               ts["far"])
    cfg_l = dataclasses.replace(
        ts["cfg"], query=dataclasses.replace(ts["cfg"].query, use_cache=True,
                                             max_q=max_q),
        train=dataclasses.replace(ts["cfg"].train, fast_path=False))

    def one_step(cf, plain=False, rays_gt=None, u_=None):
        st = create_train_state(scene.params, scene.cloud, cf)
        fn = make_train_step(cf)

        def cap(qs_, bp_):
            captured.setdefault("fvc_train", (qs_, bp_))
            return orig_fvc(qs_, bp_)

        lr.first_valid_cols = sl.first_valid_cols_reference if plain else cap
        _cuda.LAUNCHES.clear()
        try:
            st, aux = fn(st, grid_c, *batch[:2],
                         *(rays_gt or batch[2:4]), near, far,
                         jitter_u=u if u_ is None else u_)
        finally:
            lr.first_valid_cols = orig_fvc
        torch.cuda.synchronize()
        pts = list(st.points.trainable().values())
        ten = [p.grad for p in st.params.parameters()] + [p.grad for p in pts]
        ten += [p.detach() for p in st.params.parameters()] + pts
        return aux, ten, dict(_cuda.LAUNCHES)

    step_k = one_step(cfg_l)
    step_k2 = one_step(cfg_l)
    step_p = one_step(cfg_l, plain=True)
    check_launches("legacy train step", step_k[2],
                   {"first_valid_cols": 1, "fused_decode": 0, **none_else})
    check_launches("legacy train step (plain)", step_p[2],
                   {"first_valid_cols": 0})
    same_step("legacy kernel step vs plain step", step_k, step_p)
    same_step("legacy kernel step run twice", step_k, step_k2)
    del step_k2, step_p

    # ---- the legacy step against the fast step at float32: no ray packing
    # and SR slots a ray on both, one batch, one jitter draw. The two
    # routes round a candidate's distance in other orders (the legacy
    # route from its absolute xyz, the fast one from its offset to the
    # voxel centre), as the reference's two routes do, so at a near tie
    # they can pick other neighbours: such slots are counted, bounded by
    # 1e-3 of the valid slots (the bound tests/test_native_parity.py
    # gives neighbour mismatches), and their rays leave the batch before
    # the reference's contract is checked on the rest
    f32 = {"compute_dtype": "float32"}
    cfg_l32 = dataclasses.replace(cfg_l, agg=dataclasses.replace(
        cfg_l.agg, **f32))
    cfg_f32 = dataclasses.replace(
        ts["cfg"], agg=dataclasses.replace(ts["cfg"].agg, **f32),
        query=dataclasses.replace(ts["cfg"].query, ray_budget=0,
                                  ray_slot_budget=q.SR))
    geo, rmin, svs = ts["geo"]
    # both steps gather their attributes through neural_points.gather_rows
    # (the legacy step once, the fast step once a chunk)
    ids = {"legacy": [], "fast": []}
    orig_g, orig_cs = npm.gather_rows, lr.compact_samples
    route = ["legacy"]

    def cap_g(t_, i_):
        ids[route[0]].append(i_)
        return orig_g(t_, i_)

    def cap_cs(*a):
        ids["compact"] = orig_cs(*a)
        return ids["compact"]

    npm.gather_rows, lr.compact_samples = cap_g, cap_cs
    try:
        with torch.no_grad():
            o_l = lr.render_rays(scene.params, scene.cloud, grid_c, *batch[:3],
                                 near, far, cfg_l32, training=True,
                                 jitter_u=u)
            route[0] = "fast"
            o_f = ft.fast_train_render(scene.params, scene.cloud, geo,
                                       *batch[:3], near, far, cfg_f32, rmin,
                                       svs, training=True, jitter_u=u)
    finally:
        npm.gather_rows, lr.compact_samples = orig_g, orig_cs
    K = q.K
    i_l = ids["legacy"][-1].view(-1, K)
    i_f = torch.cat(ids["fast"]).view(-1, K)[:i_l.shape[0]]
    flip = (torch.sort(torch.where(o_l.pnt_mask, i_l, -1), -1).values
            != torch.sort(torch.where(o_f.pnt_mask, i_f, -1), -1).values
            ).any(-1)
    _, mask_c, ray_id = ids["compact"]
    n_valid = int(mask_c.sum())
    bad_rays = torch.unique(ray_id[flip & mask_c])
    keep = torch.ones(TRAIN_RAYS, dtype=torch.bool, device=dev)
    keep[bad_rays] = False
    if not torch.equal(o_l.ray_mask, o_f.ray_mask):
        fail("legacy vs fast step: ray_mask differs")
    if int(flip.sum()) > 1e-3 * n_valid:
        fail(f"legacy vs fast step: {int(flip.sum())} of {n_valid} slots "
             f"with other neighbours")

    def compare(sub):
        b_ = [x[sub] for x in batch[2:4]]
        a_l = one_step(cfg_l32, rays_gt=b_, u_=u[sub])
        st_f = create_train_state(scene.params, scene.cloud, cfg_f32)
        st_f, aux_f = ft.make_fast_train_step(cfg_f32)(
            st_f, geo, rmin, svs, *batch[:2], *b_, near, far,
            jitter_u=u[sub])
        g_l = a_l[1][:len(a_l[1]) // 2]
        g_f = ([p.grad for p in st_f.params.parameters()]
               + [p.grad for p in st_f.points.trainable().values()])
        l_l, l_f = float(a_l[0]["total"]), float(aux_f["total"])
        worst = max(float(((x - y).abs() / (1e-6 + 2e-3 * y.abs())).max())
                    for x, y in zip(g_l, g_f))
        return l_l, l_f, abs(l_l - l_f) / abs(l_f), worst

    full = compare(torch.ones_like(keep))
    kept = compare(keep)
    log(f"legacy vs fast step at float32: {int(flip.sum())} of {n_valid} "
        f"slots pick other neighbours (on {bad_rays.numel()} rays); all "
        f"{TRAIN_RAYS} rays: loss {full[0]:.9g} / {full[1]:.9g} (rel "
        f"{full[2]:.2e}), largest gradient |diff| / (1e-6 + 2e-3 |fast|) "
        f"{full[3]:.3f}; the {int(keep.sum())} other rays: loss rel "
        f"{kept[2]:.2e}, largest ratio {kept[3]:.3f}")
    if kept[2] > 1e-4 or kept[3] > 1.0:
        fail("legacy step differs from the fast step at float32")
    legacy_vs_fast = {"flipped_slots": int(flip.sum()), "valid_slots": n_valid,
                      "flipped_rays": int(bad_rays.numel()),
                      "all_rays": full, "other_rays": kept}
    del o_l, o_f, ids

    # ---- fit(fast_path=False): the user's entry point, 100 steps, from an
    # empty out_dir (fit() resumes from a checkpoint there)
    shutil.rmtree("build/train_legacy", ignore_errors=True)
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = loop.fit(cfg_l, ds, scene.params, scene.cloud, "build/train_legacy",
                   max_steps=TRAIN_STEPS, print_freq=10, seed=3, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    got_f = dict(_cuda.LAUNCHES)
    first, last = res.log[0]["total"], res.log[-1]["total"]
    log(f"fit legacy: {TRAIN_STEPS} steps in {t_fit:.1f} s (grid and cache "
        f"build included); launches {got_f}; loss over steps 1-10 "
        f"{first:.6f}, steps {TRAIN_STEPS - 9}-{TRAIN_STEPS} {last:.6f}: "
        f"{first / last:.1f}x")
    check_launches("fit legacy", got_f, {"first_valid_cols": TRAIN_STEPS,
                                         "fused_decode": 0, **none_else})
    if len(res.log) != TRAIN_STEPS // 10 or not first >= 4.0 * last:
        fail(f"fit legacy: the loss fell {first:.6f} -> {last:.6f}, less "
             f"than 4x")
    del res

    # ---- it/s: the legacy step and the fast dense step in turns, each
    # also with the gather backward's prefix sums as one 1-D torch.cumsum
    # (the scan before `neural_points._prefix_sums`, whose float sums group
    # differently from run to run): what the deterministic scan costs
    scan_2l = npm._prefix_sums

    def scan_1d(x):
        return torch.cumsum(x, 0)

    def with_scan(fn, scan):
        def run(*a):
            npm._prefix_sums = scan
            try:
                return fn(*a)
            finally:
                npm._prefix_sums = scan_2l
        return run

    runs = {}
    for name, cf, scan in (("legacy", cfg_l, scan_2l),
                           ("fast dense", ts["cfg"], scan_2l),
                           ("legacy 1-D scan", cfg_l, scan_1d),
                           ("fast dense 1-D scan", ts["cfg"], scan_1d)):
        g = torch.Generator(device=dev).manual_seed(5)
        if cf is cfg_l:
            fn_l = make_train_step(cf)

            def fn(st, cp, cr, rd, gt, g, fn_l=fn_l):
                return fn_l(st, grid_c, cp, cr, rd, gt, near, far,
                            generator=g)
        else:
            fn_f = ft.make_fast_train_step(cf)

            def fn(st, cp, cr, rd, gt, g, fn_f=fn_f):
                return fn_f(st, geo, rmin, svs, cp, cr, rd, gt, near, far,
                            generator=g)
        runs[name] = dict(cf=cf, fn=with_scan(fn, scan), g=g, ips=[],
                          st=create_train_state(scene.params, scene.cloud,
                                                cf),
                          smp=loop.DeviceSampler(ds, TRAIN_RAYS, g))

    def go(r, n):
        for _ in range(n):
            cp, cr, rd, gt, _ = r["smp"].next_batch()
            r["st"], _ = r["fn"](r["st"], cp, cr, rd, gt, r["g"])

    ips = steps_in_turns(runs, go, c.smi)

    # ---- a legacy step split into forward, backward and optimizer; the
    # attribute gather's backward must be gather_rows', not torch's
    # indexing backward
    r = runs["legacy"]
    cp, cr, rd, gt, _ = r["smp"].next_batch()
    st = r["st"]

    def fwd():
        st.zero_grad()
        return compute_losses(lr.render_rays(
            st.params, st.points, grid_c, cp, cr, rd, near, far, cfg_l,
            training=True, generator=r["g"]), gt, cfg_l.train)[0]

    prof = step_profile("train legacy", fwd, lambda: apply_updates(st, cfg_l),
                        c.prof_dir)
    bad = [n for n in prof.pop("names") if "indexing_backward" in n]
    if bad:
        fail(f"legacy train step: torch's indexing backward ran: {bad}")
    npm._prefix_sums = scan_1d
    try:
        prof_1d = step_profile("train legacy 1-D scan", fwd,
                               lambda: apply_updates(st, cfg_l), c.prof_dir)
    finally:
        npm._prefix_sums = scan_2l
    prof_1d.pop("names")

    qs_t, bp_t = captured["fvc_train"]
    t_sel = cuda_ms(lambda: sl.first_valid_cols(qs_t, bp_t), 48, 3,
                    queued=True)
    t_sel_p = cuda_ms(lambda: sl.first_valid_cols_reference(qs_t, bp_t), 20,
                      2)
    b_sel = bound(nbytes(qs_t) + qs_t.shape[0] * (bp_t + 1) * 4, 0)
    log(f"legacy train: first_valid_cols == plain on qs {tuple(qs_t.shape)} "
        f"BP {bp_t}: {t_sel:.4f} ms queued, plain {t_sel_p:.4f}, bound "
        f"{b_sel[0]:.4f}; fused_decode (cache route, M "
        f"{pair_a[1].shape[0]}): {t_pt:.3f} ms, plain {t_pt_p:.3f}, bound "
        f"{b_pt[0]:.3f} by {b_pt[1]}")
    return {
        "select": dict(launches=got_f.get("first_valid_cols", 0), per_step=1,
                       ms=t_sel, plain_ms=t_sel_p, bound_ms=b_sel[0],
                       qs=list(qs_t.shape), bp=bp_t),
        "decode": dict(launches=got_s["fused_decode"], ms=t_pt,
                       plain_ms=t_pt_p, bound_ms=b_pt[0], err=pair_err,
                       m=pair_a[1].shape[0]),
        "launches": {"legacy_cache_chunk": got_s, "fit_legacy": got_f},
        "cache_bytes": cache_bytes, "cache_s": t_cache,
        "chunk_ms": {"cache": t_c, "grid": t_g},
        "served_vs_plain": served_diff, "weight_kernels": kernels,
        "legacy_vs_fast_f32": legacy_vs_fast,
        "it_per_s": ips, "fit": {"first": first, "last": last, "s": t_fit},
        "profile": prof, "profile_1d_scan": prof_1d,
    }


def in_wedge(xyz, centre_deg: float, width_deg: float, widen: float = 0.0):
    """[N] bool: points of xyz [N, 3] (numpy) whose azimuth about the z axis
    lies within width_deg / 2 of centre_deg (tools/validate_chair.py's
    hole wedge, turned to `centre_deg`), or, with `widen`, that lie within
    that distance of the wedge."""
    az = np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0]))
    off = np.abs((az - centre_deg + 180.0) % 360.0 - 180.0) - width_deg / 2
    r = np.linalg.norm(xyz[:, :2], axis=-1)
    gap = np.where(off < 90.0, r * np.sin(np.radians(np.clip(off, 0, 90))),
                   r)
    return (off <= 0) | (gap < widen)


def structure_phase(c) -> dict:
    """Growth, pruning, evaluation and checkpoints at full width (section
    11 of the module docstring). Returns the numbers of its checks."""
    import copy

    import torch
    from pointnerf2studio_torch.data.blender import BlenderDataset
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import neural_points as npm
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops.grid import build_grid_from_points
    from pointnerf2studio_torch.train import evaluator as ev
    from pointnerf2studio_torch.train import grow as gr
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.trainer import (
        create_train_state, make_train_step)
    from pointnerf2studio_torch.utils import checkpoint_io as cio

    scene, dev, ts = c.scene, c.dev, c.train_setup
    sync = torch.cuda.synchronize
    # the phase's weights: at the scene's own every hit ray's max opacity
    # is 0.0198 to four digits (the density head's random part is some
    # 1e-4 of its +5 bias), so no threshold separates rays and rounding
    # decides the argmax; mlp_base's first layer x4 and the density head
    # x30 make the density vary along a ray (max opacity 0.0059-0.0073
    # between the 10th and 90th percentile of a view's hit rays). At the
    # preset's learning rates two Adam steps move each weight of that
    # tower far enough to zero the density everywhere; the phase trains at
    # STRUCT_LR_SCALE of them
    params = copy.deepcopy(scene.params)
    with torch.no_grad():
        params.mlp_base[0].weight.mul_(STRUCT_BASE_SCALE)
        params.density_head[0].weight.mul_(STRUCT_DENSITY_SCALE)
    near, far = scene.near, scene.far
    q = c.cfg.query
    svs = float(max(q.scaled_vsize))
    # the legacy configuration of the chair-train cell: the cache route
    # with fused_decode on for evaluation, the fit() default, and the chair
    # preset's compact_budget 0 (SR slots a ray: the bench's 8 is sized for
    # the fast path's packed batches, and the legacy route drops the
    # samples of a dense full-image chunk past it with no counter)
    cfg_l = dataclasses.replace(
        ts["cfg"], query=dataclasses.replace(
            ts["cfg"].query, use_cache=True, compact_budget=0,
            max_q=c.cache.max_q + STRUCT_MAXQ_MARGIN),
        agg=dataclasses.replace(ts["cfg"].agg, fused_decode=True),
        train=dataclasses.replace(
            ts["cfg"].train, fast_path=False,
            lr_fields=ts["cfg"].train.lr_fields * STRUCT_LR_SCALE,
            lr_points=ts["cfg"].train.lr_points * STRUCT_LR_SCALE))
    # the fused-chunk configuration of the frame phases, for render_frame
    cfg_f = dataclasses.replace(c.cfg, query=dataclasses.replace(
        q, depth_window=0, ray_budget=0))

    # ---- 1. teacher views of the intact cloud through render_frame
    poses = np.stack([orbit_pose(30.0 + 90.0 * v) for v in range(4)])
    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    ds = BlenderDataset(images=np.zeros((4, H, W, 3), np.float32),
                        poses=poses, intrinsics=intr, near=near, far=far,
                        split="train")

    def dev_t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    sync()
    t0 = time.perf_counter()
    for v in range(4):
        out = fr.render_frame(
            params, scene.cloud.Rw2c, c.cache, dev_t(ds.campos(v)),
            dev_t(ds.camrotc2w(v)), dev_t(ds.full_image_rays(v)), near, far,
            cfg_f, c.rmin, c.svs, host_rays=ds.full_image_rays(v))
        ds.images[v] = out.coarse_raycolor.reshape(H, W, 3).cpu().numpy()
    t_teach = time.perf_counter() - t0
    bg = np.asarray(cfg_f.bg_color, np.float32)
    fg = [float((np.abs(ds.images[v] - bg).sum(-1) > 0).mean())
          for v in range(4)]
    log(f"structure: 4 teacher views {H}x{W} of the intact cloud through "
        f"render_frame in {t_teach:.2f} s; foreground share {fg}")

    rays0 = dev_t(ds.full_image_rays(0))
    cp0, cr0 = dev_t(ds.campos(0)), dev_t(ds.camrotc2w(0))
    sync()
    t0 = time.perf_counter()
    cfg_p, pcache, rmin, svs_t = gr.make_probe_scene(cfg_l, scene.cloud,
                                                     scene.grid)
    sync()
    t_pcache = time.perf_counter() - t0
    pcache_bytes = nbytes(pcache.kmeta, pcache.kcand, pcache.kxyz)
    log(f"structure: the probe's fat cache ({pcache.max_q} x {pcache.cand} "
        f"candidates, kmeta, kcand and kxyz) {pcache_bytes} B built in "
        f"{t_pcache:.2f} s; the reference's rows layout of the same "
        f"candidates would be {pcache.max_q * pcache.cand * fr.ROWW * 4} B")

    def xla_route(rays, cf=cfg_p, prob=False):
        return fr.fast_render_rays(params, scene.cloud.Rw2c, pcache,
                                   cp0, cr0, rays, near, far, cf, rmin,
                                   svs_t, prob=prob)

    # the fast probe keeps the first ray_slot_budget (32) samples of a ray,
    # the legacy route the first SR (80); where the opacity is flat, the
    # argmax over 80 samples is another sample than over 32, so the legacy
    # probe is compared at SR 32
    cfg_lp = dataclasses.replace(cfg_l, query=dataclasses.replace(
        cfg_l.query, SR=min(cfg_l.query.SR, cfg_l.query.ray_slot_budget)))

    def probe_maps(prm, cloud, grid, fs_):
        """view 0's ray_mask and prob maps through the fast probe (`fs_`,
        from make_probe_scene) or the legacy one (`fs_` None)."""
        out = []
        with torch.no_grad():
            for i in range(0, H * W, CHUNK):
                rd = rays0[i:i + CHUNK]
                if fs_ is not None:
                    cf, cch, rm, sv = fs_
                    o = fr.fast_render_rays(prm, cloud.Rw2c, cch, cp0, cr0,
                                            rd, near, far, cf, rm, sv,
                                            prob=True)
                else:
                    o = lr.render_rays(prm, cloud, grid, cp0, cr0, rd, near,
                                       far, cfg_lp, prob=True)
                out.append([o.ray_mask] + [getattr(o, f)
                                           for f in fr.PROB_FIELDS])
        return [torch.cat(x) for x in zip(*out)]

    def quantiles(mp):
        ops = torch.sort(mp[1][mp[0]]).values
        return [float(ops[int(p * (len(ops) - 1))]) for p in (0.1, 0.5, 0.9)]

    # why the phase rescales the weights: view 0 at the scene's own
    w_own = scene.params
    mp_f = probe_maps(w_own, scene.cloud, None,
                      (cfg_p, pcache, rmin, svs_t))
    mp_l = probe_maps(w_own, scene.cloud, scene.grid, None)
    both = mp_f[0] & mp_l[0]
    own_within = float(((mp_f[2] - mp_l[2]).norm(dim=-1)[both] < svs)
                       .float().mean())
    log(f"structure: at the scene's own weights view 0's max shading "
        f"opacity 10/50/90th {[round(x, 5) for x in quantiles(mp_f)]}, "
        f"fast against legacy probe location within a voxel on "
        f"{own_within:.4f} of the rays both hit (not held: the phase's "
        f"weights are rescaled)")
    del mp_f, mp_l, w_own

    # the probe threshold: the median of the max shading opacity of view
    # 0's hit rays, measured once on the intact cloud. The preset's 0.7 is
    # out of reach at random weights, where a surface sample's alpha is
    # some 1e-2
    qs_op = quantiles(probe_maps(params, scene.cloud, None,
                                 (cfg_p, pcache, rmin, svs_t)))
    thresh = qs_op[1]
    log(f"structure: probe threshold {thresh:.4f}, the median of the max "
        f"shading opacity of view 0's hit rays before the cut (10/50/90th: "
        f"{[round(x, 4) for x in qs_op]}); the preset's 0.7 is out of reach "
        f"at random weights")

    # ---- 2. the XLA route on one chunk of view 0 against the fused chunk
    mid = (H * W) // 2 - CHUNK // 2
    rc = rays0[mid:mid + CHUNK]
    cfg_pf = dataclasses.replace(cfg_p, query=dataclasses.replace(
        cfg_p.query, chunk_mode="fused"))

    def fused_route(rays):
        return fr.fast_render_rays(params, scene.cloud.Rw2c, c.cache,
                                   cp0, cr0, rays, near, far, cfg_pf, c.rmin,
                                   c.svs)

    _cuda.LAUNCHES.clear()
    o_x = xla_route(rc)
    sync()
    check_launches("XLA route chunk", dict(_cuda.LAUNCHES),
                   {"first_valid_cols": 1, "fused_chunk_decode": 0,
                    "fused_candidate_select": 0, "fused_decode2": 0})
    o_f = fused_route(rc)
    if not torch.equal(o_x.ray_mask, o_f.ray_mask):
        fail("XLA route: ray_mask differs from the fused-chunk route")
    d = (o_x.coarse_raycolor - o_f.coarse_raycolor).abs()
    xla_diff = (float(d.max()), float(d.mean()))
    if not (xla_diff[0] <= ATOL and xla_diff[1] < MEAN_TOL):
        fail(f"XLA route: colour {xla_diff} off the fused-chunk route")
    cfg_pp = dataclasses.replace(cfg_p, query=dataclasses.replace(
        cfg_p.query, select_mode="topk"))
    _cuda.LAUNCHES.clear()
    p_k = xla_route(rc, prob=True)
    sync()
    got_pk = dict(_cuda.LAUNCHES)
    _cuda.LAUNCHES.clear()
    p_p = xla_route(rc, cfg_pp, prob=True)
    sync()
    check_launches("XLA route prob (kernel)", got_pk,
                   {"first_valid_cols": 1})
    check_launches("XLA route prob (plain)", dict(_cuda.LAUNCHES),
                   {"first_valid_cols": 0})
    for f in ("ray_mask", "coarse_raycolor") + fr.PROB_FIELDS:
        if not torch.equal(getattr(p_k, f), getattr(p_p, f)):
            fail(f"XLA route prob: {f} differs between first_valid_cols "
                 f"and its plain version")
    n_hit = int(o_x.ray_mask.sum())
    t_x, t_f = [], []
    for _ in range(3):
        t_x.append(cuda_ms(lambda: xla_route(rc), 1, 0))
        t_f.append(cuda_ms(lambda: fused_route(rc), 1, 0))
    log(f"structure: XLA route chunk ({CHUNK} rays, {n_hit} hit, "
        f"{int(o_x.n_valid_slots)} slots) vs fused chunk: ray_mask equal, "
        f"colour max |diff| {xla_diff[0]:.3e} mean {xla_diff[1]:.3e}; "
        f"prob outputs kernel == plain bit for bit; {min(t_x):.2f} ms "
        f"against {min(t_f):.2f} ms, best of 3 in turns")
    del o_x, o_f, p_k, p_p

    # ---- the cut: an azimuth wedge facing view 0's camera, clean
    # through the chair; the state trains 2 legacy steps first, so the cut
    # slots carry Adam moments that growth must reset
    xyz_np = scene.cloud.xyz.cpu().numpy()
    cam_az = float(np.degrees(np.arctan2(poses[0, 1, 3], poses[0, 0, 3])))
    wedge = in_wedge(xyz_np, cam_az, STRUCT_WEDGE_DEG)
    cut_alive = scene.cloud.alive & ~torch.as_tensor(wedge, device=dev)
    log(f"structure: hole wedge {STRUCT_WEDGE_DEG} deg at azimuth "
        f"{cam_az:.1f}: {int(wedge.sum())} points cut of "
        f"{scene.cloud.capacity}")
    # two legacy steps at learning rate 0: Adam moments from real
    # gradients on every live point, the weights as they were
    st = create_train_state(params, scene.cloud, cfg_l)
    step_fn = make_train_step(cfg_l)
    smp = loop.DeviceSampler(ds, cfg_l.train.rays_per_batch,
                             torch.Generator(device=dev).manual_seed(2))
    nr, fa = torch.tensor(near, device=dev), torch.tensor(far, device=dev)
    for _ in range(2):
        for opt in (st.opt_fields, st.opt_points):
            for g in opt.param_groups:
                g["lr"] = 0.0
        cp, cr, rd, gt, _ = smp.next_batch()
        step_fn(st, scene.grid, cp, cr, rd, gt, nr, fa,
                generator=smp.g)
    st.points = dataclasses.replace(st.points, alive=cut_alive)
    cut_cloud = st.points
    sync()
    t0 = time.perf_counter()
    grid_cut = build_grid_from_points(cut_cloud.xyz, cut_cloud.alive,
                                      cfg_l.query)
    sync()
    log(f"structure: grid and candidate cache of the cut cloud rebuilt in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. the probes of view 0: fast against legacy on every ray
    fast_scene = gr.make_probe_scene(cfg_l, cut_cloud, grid_cut)

    # the reference's bounds (tests/test_grow.py:191-203): ray_mask
    # agreement >= 0.99; the max-opacity location within a voxel on >= 0.9
    # of the rays both hit; where it is the same sample, the opacity within
    # 2e-2 and the neighbour averages within 3e-2. The last holds on >= 0.9
    # of those rays here, not on all: the fast probe ranks candidates by
    # d2 from bf16 offsets, the legacy by f32 positions, so near-equal
    # distances at the K-th neighbour swap a neighbour, which moves a dir
    # or embedding average by up to about 2 / K (largest error printed)
    mp_f = probe_maps(st.params, cut_cloud, None, fast_scene)
    mp_l = probe_maps(st.params, cut_cloud, grid_cut, None)
    agree = float((mp_f[0] == mp_l[0]).float().mean())
    both = mp_f[0] & mp_l[0]
    dloc = (mp_f[2] - mp_l[2]).norm(dim=-1)
    within = float((dloc[both] < svs).float().mean())
    same = both & (dloc < 1e-4)
    n_same = int(same.sum())
    errs = {f: (a[same] - b[same]).abs().reshape(n_same, -1)
            .amax(-1) for f, a, b in zip(fr.PROB_FIELDS, mp_f[1:], mp_l[1:])
            if f != "ray_max_sample_loc_w"}
    op_err = float(errs.pop("ray_max_shading_opacity").max())
    avg_bad = int((torch.stack(list(errs.values())).amax(0) >= 3e-2).sum())
    avg_ok = 1.0 - avg_bad / max(n_same, 1)
    errs = {k: float(v.max()) for k, v in errs.items()}
    if agree < 0.99 or within < 0.9 or op_err >= 2e-2 or avg_ok < 0.9:
        fail(f"probe: fast against legacy mask agreement {agree:.4f} "
             f"(>= 0.99), location within a voxel {within:.4f} (>= 0.9), "
             f"where the sample is the same opacity error {op_err:.3e} "
             f"(< 2e-2) and averages within 3e-2 on {avg_ok:.4f} (>= 0.9)")
    del mp_f, mp_l
    probe_s = {}
    n_cand = {}
    for name, fs_ in (("fast", fast_scene), ("legacy", None)):
        _cuda.LAUNCHES.clear()
        sync()
        t0 = time.perf_counter()
        cand = gr.probe_view(cfg_lp, st.params, cut_cloud, grid_cut, ds, 0,
                             chunk=CHUNK, opacity_thresh=thresh,
                             prob_mul=0.4, fast_scene=fs_)
        sync()
        probe_s[name] = time.perf_counter() - t0
        n_cand[name] = int(cand["xyz"].shape[0])
        if name == "fast":
            check_launches("fast probe", dict(_cuda.LAUNCHES),
                           {"first_valid_cols": -(-H * W // CHUNK),
                            "fused_chunk_decode": 0, "fused_decode": 0})
    del fast_scene
    log(f"structure: probe of view 0 ({H * W} rays): fast against legacy "
        f"mask agreement {agree:.5f}, location within a voxel on "
        f"{within:.5f} of the rays both hit, the same sample on "
        f"{n_same} rays: opacity error {op_err:.3e}, averages "
        f"within 3e-2 on {avg_ok:.4f} ({avg_bad} rays off; largest {errs}); "
        f"candidates "
        f"{n_cand}; "
        f"{probe_s['fast']:.2f} s fast, {probe_s['legacy']:.2f} s legacy")

    alive0 = st.points.alive.clone()
    n0 = int(alive0.sum())
    tm = {}
    _cuda.LAUNCHES.clear()
    st, grid_g, n_new = gr.probe_and_grow(
        cfg_l, st, grid_cut, ds, views=[0], chunk=CHUNK,
        opacity_thresh=thresh, prob_mul=0.4, timings=tm)
    got_g = dict(_cuda.LAUNCHES)
    grown = torch.nonzero(st.points.alive & ~torch.cat(
        [alive0, alive0.new_zeros(st.points.capacity - alive0.shape[0])])
    ).squeeze(1)
    if n_new <= 0 or grown.shape[0] != n_new:
        fail(f"growth: {n_new} grown, {grown.shape[0]} new live slots")
    if int(st.points.num_alive) != n0 + n_new:
        fail("growth: n_alive after is not n_alive before + grown")
    gxyz = st.points.xyz[grown].cpu().numpy()
    in_w = float(in_wedge(gxyz, cam_az, STRUCT_WEDGE_DEG, widen=svs).mean())
    if in_w < 0.8:
        fail(f"growth: {in_w:.3f} of the grown points in the wedge "
             f"widened by one voxel (>= 0.8)")
    for p in st.points.trainable().values():
        mom = st.opt_points.state[p]
        if any(float(mom[k][grown].abs().max()) != 0.0
               for k in ("exp_avg", "exp_avg_sq")):
            fail("growth: a grown slot kept its Adam moments")
    recycled = int(torch.as_tensor(wedge, device=dev)[
        grown[grown < wedge.shape[0]]].sum())
    log(f"structure: growth grew {n_new} points ({recycled} into slots of "
        f"cut points whose moments were reset), {in_w:.4f} of them within "
        f"the wedge widened by a voxel; n_alive {n0} -> "
        f"{int(st.points.num_alive)}; launches {got_g}; probe "
        f"{tm['probe_s']:.2f} s, grow {tm['grow_s']:.3f} s, grid rebuild "
        f"{tm['rebuild_s']:.2f} s")
    del st, grid_g, grid_cut

    # ---- 4. fit(): prune at 40 and 80, grow at 50 and 100, save and
    # evaluate at 50 and 100; a third of a percent of the points planted
    # at conf 0.01 so that the first prune has points to kill
    conf = scene.cloud.points_conf.clone()
    conf[::300] = 0.01
    cloud_fit = dataclasses.replace(scene.cloud, alive=cut_alive,
                                    points_conf=conf)
    cfg_fit = dataclasses.replace(cfg_l, train=dataclasses.replace(
        cfg_l.train, prune_iter=40, prune_thresh=0.1, prune_max_iter=100_000,
        prob_freq=50, prob_thresh=thresh, prob_mul=0.4,
        color_loss_items=("ray_masked_coarse_raycolor",
                          "ray_miss_coarse_raycolor"),
        color_loss_weights=(1.0, 0.0)))
    out_dir = "build/structure"
    shutil.rmtree(out_dir, ignore_errors=True)
    prunes, parts = [], {"probe": [], "eval": []}
    orig_prune, orig_pg, orig_ev = npm.prune, loop.probe_and_grow, \
        loop.evaluate_dataset

    def cap_prune(points, thr):
        res = orig_prune(points, thr)
        prunes.append((points.alive.clone(), points.points_conf.detach()
                       [:, 0].clone(), thr, res.alive.clone()))
        return res

    def counted(name, fn):
        def run(*a, **k):
            before = dict(_cuda.LAUNCHES)
            sync()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            sync()
            parts[name].append((
                {n: v - before.get(n, 0) for n, v in _cuda.LAUNCHES.items()},
                time.perf_counter() - t0))
            return res
        return run

    npm.prune = cap_prune
    loop.probe_and_grow = counted("probe", orig_pg)
    loop.evaluate_dataset = counted("eval", orig_ev)
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        res = loop.fit(cfg_fit, ds, params, cloud_fit, out_dir,
                       max_steps=STRUCT_STEPS, print_freq=10, save_freq=50,
                       eval_freq=50, eval_dataset=ds, eval_views=[0],
                       eval_chunk=4096, seed=5, device=dev)
        sync()
    finally:
        npm.prune, loop.probe_and_grow, loop.evaluate_dataset = (
            orig_prune, orig_pg, orig_ev)
    t_fit = time.perf_counter() - t0
    got_fit = dict(_cuda.LAUNCHES)
    # the checks
    gh = res.grow_history
    if [g["step"] for g in gh] != [50, 100] or gh[0]["grown_points"] <= 0:
        fail(f"fit: growth history {gh}")
    if len(prunes) != 2:
        fail(f"fit: {len(prunes)} prunes, expected 2 (steps 40 and 80)")
    killed = []
    for alive_b, conf_b, thr, alive_a in prunes:
        if not torch.equal(alive_a, alive_b & (conf_b >= thr)):
            fail("fit: a prune killed other points than the live ones "
                 "under the threshold")
        killed.append(int((alive_b & ~alive_a).sum()))
    if killed[0] <= 0:
        fail("fit: the first prune killed no point")
    n_eval_chunks = -(-H * W // 4096)
    # fused_decode runs once per decode piece of each legacy chunk
    qf = cfg_fit.query
    n_pieces = 0
    for s0 in range(0, H * W, 4096):
        r = min(4096, H * W - s0)
        m = min(r * (qf.compact_budget or qf.SR), r * qf.z_depth_dim)
        n_pieces += -(-m // qf.decode_chunk) if m > qf.decode_chunk else 1
    steps_fvc = got_fit.get("first_valid_cols", 0) - sum(
        p[0].get("first_valid_cols", 0) for v in parts.values() for p in v)
    if steps_fvc != STRUCT_STEPS:
        fail(f"fit: first_valid_cols launched {steps_fvc} times by the "
             f"steps, expected {STRUCT_STEPS}")
    for lc, _ in parts["probe"]:
        check_launches("fit probe", lc, {"first_valid_cols": n_eval_chunks,
                                         "fused_decode": 0})
    for lc, _ in parts["eval"]:
        check_launches("fit legacy eval", lc,
                       {"first_valid_cols": n_eval_chunks,
                        "fused_decode": n_pieces, "fused_chunk_decode": 0})
    # the colour loss (the total also holds the conf term, which falls
    # whatever the colour does)
    losses = [r["ray_masked_coarse_raycolor_loss"] for r in res.log
              if "total" in r]
    # it/s of the log windows clear of set-up and of the prunes (a growth
    # event and an evaluation flush the log after them; a prune does not,
    # so the window after it carries its time)
    ips = sorted(r["it_per_sec"] for r in res.log if "total" in r
                 and r["step"] not in (10, 50, 90))
    if not losses[-1] <= losses[0]:
        fail(f"fit: colour loss of steps 91-100 {losses[-1]:.3e} above "
             f"steps 1-10's {losses[0]:.3e}")
    eh = res.eval_history
    if ([e["step"] for e in eh] != [50, 100, 100]
            or not all(np.isfinite(e["psnr"]) for e in eh)):
        fail(f"fit: eval history {eh}")
    if res.state.step != STRUCT_STEPS:
        fail(f"fit: state.step {res.state.step}")
    log(f"structure fit: {STRUCT_STEPS} legacy steps in {t_fit:.1f} s "
        f"({ips[len(ips) // 2]:.2f} it/s, the median log window clear of "
        f"the events); "
        f"prunes killed {killed}; growth {gh}; eval psnr "
        f"{[round(e['psnr'], 3) for e in eh]}; colour loss {losses[0]:.3e} "
        f"-> {losses[-1]:.3e}; launches {got_fit} (steps: first_valid_cols "
        f"{steps_fvc}); probe events {[round(p[1], 2) for p in parts['probe']]}"
        f" s, evaluations {[round(p[1], 2) for p in parts['eval']]} s")

    # resume: a finished run returns without a step, bit for bit
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    res2 = loop.fit(cfg_fit, ds, params, cloud_fit, out_dir,
                    max_steps=STRUCT_STEPS, print_freq=10, save_freq=50,
                    seed=5, device=dev)
    sync()
    t_restore = time.perf_counter() - t0
    if res2.log or sum(_cuda.LAUNCHES.values()) or res2.state.step != 100:
        fail("fit resume: the finished run took steps")
    a, b = res.state, res2.state
    same = [torch.equal(x.detach(), y.detach()) for x, y in zip(
        list(a.params.parameters()) + list(a.points.trainable().values())
        + [a.points.xyz, a.points.alive],
        list(b.params.parameters()) + list(b.points.trainable().values())
        + [b.points.xyz, b.points.alive])]
    for oa, ob in ((a.opt_fields, b.opt_fields), (a.opt_points, b.opt_points)):
        for pa, pb in zip(oa.param_groups[0]["params"],
                          ob.param_groups[0]["params"]):
            same += [torch.equal(oa.state[pa][k], ob.state[pb][k])
                     for k in ("exp_avg", "exp_avg_sq")]
            same.append(float(oa.state[pa]["step"])
                        == float(ob.state[pb]["step"]))
    if not all(same):
        fail("fit resume: the restored state differs from the saved one")
    _cuda.LAUNCHES.clear()
    res3 = loop.fit(cfg_fit, ds, params, cloud_fit, out_dir,
                    max_steps=STRUCT_STEPS + 10, print_freq=10, save_freq=50,
                    seed=5, device=dev)
    sync()
    if ([r["step"] for r in res3.log] != [STRUCT_STEPS + 10]
            or res3.state.step != STRUCT_STEPS + 10
            or _cuda.LAUNCHES["first_valid_cols"] != 10):
        fail("fit resume: max_steps 110 did not resume at step 101")
    sync()
    t0 = time.perf_counter()
    cio.save_train_state(out_dir + "/ckpt", res.state, STRUCT_STEPS)
    sync()
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = cio.restore_train_state(out_dir + "/ckpt", STRUCT_STEPS,
                                   create_train_state(params,
                                                      cloud_fit, cfg_fit),
                                   cfg_fit)
    sync()
    t_load = time.perf_counter() - t0
    path = out_dir + "/export.pth"
    cio.export_torch_checkpoint(res.state.params, res.state.points, path)
    p2, pts2 = cio.load_reference_checkpoint(path, cfg_fit.agg, device=dev)
    live = res.state.points.alive
    ok = all(torch.equal(x.weight, y.weight) and torch.equal(x.bias, y.bias)
             for n in p2.towers if n != "feat_weight_mlp"
             for x, y in zip(getattr(p2, n), getattr(res.state.params, n)))
    for f in ("xyz", "points_embeding", "points_conf", "points_dir",
              "points_color"):
        ok = ok and torch.equal(getattr(pts2, f),
                                getattr(res.state.points, f).detach()[live])
    if not ok or back.step != STRUCT_STEPS:
        fail("checkpoint: the .pth round trip or the native restore differs")
    log(f"structure: resume of the finished run {t_restore:.2f} s (grid "
        f"rebuild included), bit for bit; max_steps {STRUCT_STEPS + 10} "
        f"resumed at {STRUCT_STEPS + 1}; native save {t_save:.2f} s, "
        f"restore {t_load:.2f} s ({os.path.getsize(out_dir + '/ckpt/step_100/state.pt')} B); "
        f".pth round trip of {int(live.sum())} live points bit for bit")
    del res2, res3, back

    # ---- 5. evaluation of view 0, legacy against render_frame
    pts = res.state.points
    grid_e = build_grid_from_points(pts.xyz, pts.alive, cfg_l.query)
    ev_s, ev_m, ev_l = {}, {}, {}
    for name, cf, kw in (("legacy", cfg_l, dict(chunk=4096)),
                         ("fast", cfg_f, dict(chunk=CHUNK, fast=True))):
        _cuda.LAUNCHES.clear()
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            ev_m[name] = ev.evaluate_dataset(cf, res.state.params, pts,
                                             grid_e, ds, views=[0], **kw)
        sync()
        ev_s[name] = time.perf_counter() - t0
        ev_l[name] = dict(_cuda.LAUNCHES)
    check_launches("legacy evaluation", ev_l["legacy"],
                   {"first_valid_cols": n_eval_chunks,
                    "fused_decode": n_pieces, "fused_chunk_decode": 0})
    n_fc = ev_l["fast"].get("fused_chunk_decode", 0)
    check_launches("fast evaluation", ev_l["fast"],
                   {"first_valid_cols": n_fc, "fused_decode": 0,
                    "march_rays": 0})
    if n_fc <= 0:
        fail("fast evaluation: fused_chunk_decode was not launched")
    dpsnr = abs(ev_m["legacy"]["psnr"] - ev_m["fast"]["psnr"])
    if not dpsnr <= 0.5:
        fail(f"evaluation: legacy {ev_m['legacy']} against fast "
             f"{ev_m['fast']}")
    log(f"structure: evaluation of view 0: legacy psnr "
        f"{ev_m['legacy']['psnr']:.4f} in {ev_s['legacy']:.2f} s, "
        f"render_frame psnr {ev_m['fast']['psnr']:.4f} in "
        f"{ev_s['fast']:.2f} s; launches {ev_l}")
    return dict(
        probe_cache_bytes=pcache_bytes, probe_cache_s=t_pcache,
        own_weights_within_voxel=own_within, probe_threshold=thresh, n_cut=int(wedge.sum()),
        xla_vs_fused_colour=xla_diff, xla_chunk_ms=min(t_x),
        fused_chunk_ms=min(t_f), probe_agreement=agree,
        probe_within_voxel=within, probe_avg_off=avg_bad,
        probe_same_sample=n_same, probe_s=probe_s,
        probe_candidates=n_cand,
        grown=n_new, grown_in_wedge=in_w, grow_event_s=tm,
        fit_s=t_fit, fit_it_per_s=ips[len(ips) // 2], prunes_killed=killed, grow_history=gh,
        eval_history=eh, colour_loss_first_last=(losses[0], losses[-1]),
        fit_launches=got_fit, fit_probe_launches=[p[0] for p in
                                                  parts["probe"]],
        fit_eval_launches=[p[0] for p in parts["eval"]],
        resume_s=t_restore, save_s=t_save, restore_s=t_load,
        eval_psnr={k: v["psnr"] for k, v in ev_m.items()}, eval_s=ev_s,
        eval_launches=ev_l)


def make_room_cloud(n_points: int, seed: int = 0):
    """The reference's ScanNet-scale room (tools/stress_scannet_scale.py:
    50-100, numpy): points on the walls, floor and ceiling of a 6 x 6 x 3 m
    room and on 24 furniture boxes, with 2 mm noise. Returns the arrays of
    `neural_points.from_arrays` (xyz, embedding, conf, dir, colour)."""
    rng = np.random.default_rng(seed)
    hx = hy = hz = 3.0
    n_wall = int(n_points * 0.75)
    n_blob = n_points - n_wall
    faces, areas = [], []
    for z in (0.0, hz):
        faces.append(("z", z))
        areas.append(4 * hx * hy)
    for x in (-hx, hx):
        faces.append(("x", x))
        areas.append(2 * hy * hz)
    for y in (-hy, hy):
        faces.append(("y", y))
        areas.append(2 * hx * hz)
    areas = np.asarray(areas) / np.sum(areas)
    counts = rng.multinomial(n_wall, areas)
    pts = []
    for (axis, v), c in zip(faces, counts):
        u = rng.uniform(-1, 1, (c, 2))
        if axis == "z":
            p = np.stack([u[:, 0] * hx, u[:, 1] * hy, np.full(c, v)], -1)
        elif axis == "x":
            p = np.stack([np.full(c, v), u[:, 0] * hy,
                          (u[:, 1] * 0.5 + 0.5) * hz], -1)
        else:
            p = np.stack([u[:, 0] * hx, np.full(c, v),
                          (u[:, 1] * 0.5 + 0.5) * hz], -1)
        pts.append(p)
    per = n_blob // 24
    for _ in range(24):
        c = rng.uniform([-2.5, -2.5, 0.1], [2.5, 2.5, 1.2])
        half = rng.uniform(0.15, 0.6, 3)
        face = rng.integers(0, 3, per)
        sgn = rng.choice([-1.0, 1.0], per)
        u = rng.uniform(-1, 1, (per, 3)) * half
        p = c + u
        p[np.arange(per), face] = c[face] + sgn * half[face]
        pts.append(p)
    xyz = np.concatenate(pts, 0)[:n_points].astype(np.float32)
    n = xyz.shape[0]
    xyz += rng.normal(0, 0.002, xyz.shape).astype(np.float32)
    colors = (np.abs(np.sin(xyz * 3.0)) * 0.8 + 0.1).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    emb = (rng.standard_normal((n, 32)) * 0.1).astype(np.float32)
    conf = np.full((n, 1), 0.8, np.float32)
    return xyz, emb, conf, dirs, colors


def room_config():
    """The stress tool's configuration (tools/stress_scannet_scale.py:
    140-153): the ScanNet preset's voxel (0.008, vscale 2), SR 24, K 8,
    P 12, max_o 4M, D 288 over the room's ranges, cand_cap 32, compact
    budget 8, 24 slots a ray, fast_chunk 4096, the hash grid and a bf16
    aggregator at full width; near 0.2, far 9.0. The column selection
    runs through the kernel (select_mode "pallas")."""
    from pointnerf2studio_torch.config import (
        AggregatorConfig, PointNerfConfig, QueryConfig)
    return PointNerfConfig(
        query=QueryConfig(
            vsize=(ROOM_VSIZE,) * 3, vscale=(2, 2, 2), SR=24, K=8, P=12,
            max_o=4_000_000, z_depth_dim=ROOM_D,
            ranges=(-3.2, -3.2, -0.2, 3.2, 3.2, 3.2), cand_cap=32,
            use_cache=False, compact_budget=8, ray_slot_budget=24,
            fast_chunk=4096, grid_mode="hash", select_mode="pallas"),
        agg=AggregatorConfig(compute_dtype="bfloat16"),
        near_plane=0.2, far_plane=9.0)


def room_pose(az_deg: float, pos=None):
    """c2w [4, 4] of a level camera in the room looking at azimuth
    `az_deg` (0: along +y; rotation [[1, 0, 0], [0, 0, 1], [0, -1, 0]]),
    at `pos`, by default 1.2 m behind the room's centre at height 1.4."""
    az = np.deg2rad(az_deg)
    fwd = np.array([np.sin(az), np.cos(az), 0.0])
    right = np.array([np.cos(az), -np.sin(az), 0.0])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], -1)
    pose[:3, 3] = (pos if pos is not None
                   else np.array([0.0, 0.0, 1.4]) - 1.2 * fwd)
    return pose


def large_scene_phase(c) -> dict:
    """The large-scene route on the 2M-point room at the ScanNet preset's
    voxel (section "large scene" of the module docstring). Returns the
    phase's numbers and the launches of first_valid_cols and
    fused_decode2 on it."""
    import torch
    from pointnerf2studio_torch.config import TrainConfig
    from pointnerf2studio_torch.data.blender import BlenderDataset
    from pointnerf2studio_torch.data.synthetic import camera_rays
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import neural_points as npts
    from pointnerf2studio_torch.models.aggregator import Aggregator
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import fused_decode as fd
    from pointnerf2studio_torch.ops import grid as gr
    from pointnerf2studio_torch.ops import hash_grid as hgm
    from pointnerf2studio_torch.ops.select import (
        first_valid_cols, first_valid_cols_reference)
    from pointnerf2studio_torch.train import loop

    dev, smi = c.dev, c.smi
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = room_config()
    q = cfg.query
    arrays = make_room_cloud(ROOM_POINTS, seed=0)
    n_pts = arrays[0].shape[0]
    cloud = npts.from_arrays(*arrays, device=dev)
    teacher = Aggregator(cfg.agg, seed=0, device=dev)
    with torch.no_grad():
        teacher.density_head[0].bias += 5.0

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- the grids: the hash grid and the dense grid of the same cloud
    hg, t_hash = timed(lambda: hgm.build_hash_grid_from_points(
        cloud.xyz, cloud.alive, q))
    _, t_hash2 = timed(lambda: hgm.build_hash_grid_from_points(
        cloud.xyz, cloud.alive, q))
    n_occ, n_q = int(hg.n_occ), int(hg.n_q)
    log(f"large scene: {n_pts} points of the room, vsize {q.vsize[0]} x "
        f"vscale 2; hash grid logical dims {hg.dims}, n_occ {n_occ}, n_q "
        f"{n_q}, B {hg.n_buckets} x S {hg.bucket_slots}, overflow "
        f"{int(hg.overflow)}, table {nbytes(hg.table)} B; built in "
        f"{t_hash:.3f} s (again {t_hash2:.3f} s)")
    if int(hg.overflow):
        fail("large scene: the hash grid overflowed")
    cfg_d = dataclasses.replace(cfg, query=dataclasses.replace(
        q, grid_mode="dense"))
    grid, t_dense = timed(lambda: gr.build_grid_from_points(
        cloud.xyz, cloud.alive, cfg_d.query))
    n_q_dense = int(grid.coor_occ.sum())
    log(f"large scene: dense grid {grid.dims} ({grid.coor_occ.numel()} "
        f"voxels), n_occ {int(grid.n_occ)}, n_q {n_q_dense}, built in "
        f"{t_dense:.3f} s")
    if (grid.dims != hg.dims or int(grid.n_occ) != n_occ
            or n_q_dense != n_q):
        fail("large scene: the hash and dense grids differ in dims, n_occ "
             "or n_q")

    # ---- the caches: the hash fat cache and the dense one
    (hcache, rmin, svs), t_hc = timed(
        lambda: fr.make_hash_fast_scene(cfg, cloud, hg))
    (dcache, drmin, dsvs), t_dc = timed(
        lambda: fr.make_fast_scene(cfg_d, cloud, grid,
                                   max_q=hcache.max_q))
    cache_bytes = nbytes(hcache.kmeta, hcache.kcand, hcache.kxyz)
    log(f"large scene: hash fat cache max_q {hcache.max_q}, C "
        f"{hcache.cand}: kmeta + kcand + kxyz {cache_bytes} B "
        f"({cache_bytes / hcache.max_q / hcache.cand:.1f} B a candidate), "
        f"built in {t_hc:.2f} s; the dense build {t_dc:.2f} s")
    if not torch.equal(rmin, drmin):
        fail("large scene: the two grids' ranges_min differ")
    for f in ("kmeta", "kcand", "kxyz"):
        a, b = getattr(hcache, f)[:n_q], getattr(dcache, f)[:n_q]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        if not torch.equal(a, b):
            fail(f"large scene: the hash cache's {f} differs from the "
                 f"dense cache's on the first n_q rows")
    # table_qslot on every voxel of the dense box against the qslot table
    gx, gy, gz = grid.dims
    yz = torch.stack(torch.meshgrid(
        torch.arange(gy, device=dev), torch.arange(gz, device=dev),
        indexing="ij"), -1)
    n_diff = 0
    t0 = time.perf_counter()
    for x0 in range(0, gx, 32):
        xs = torch.arange(x0, min(x0 + 32, gx), device=dev)
        co = torch.cat([xs[:, None, None, None].expand(-1, gy, gz, 1),
                        yz.expand(xs.shape[0], gy, gz, 2)], -1)
        qv = hgm.table_qslot(hg.table, co,
                             torch.ones(co.shape[:-1], dtype=torch.bool,
                                        device=dev))
        n_diff += int((qv != dcache.coor_2_qslot[x0:x0 + 32]).sum())
    torch.cuda.synchronize()
    log(f"large scene: table_qslot on all {gx * gy * gz} voxels of the "
        f"dense box against coor_2_qslot: {n_diff} differ "
        f"({time.perf_counter() - t0:.2f} s); caches bit-equal on the "
        f"first {n_q} rows")
    if n_diff:
        fail("large scene: table_qslot differs from the dense qslot table")

    # ---- the frame: 640x480 through the XLA route on both caches
    campos = torch.tensor([0.0, -2.4, 1.4], device=dev)
    camrot = torch.as_tensor(room_pose(0.0)[:3, :3], device=dev)
    rays = camera_rays(camrot, ROOM_H, ROOM_W, ROOM_FOCAL)
    near, far = cfg.near_plane, cfg.far_plane
    R = rays.shape[0]
    n_ch = -(-R // CHUNK)
    dw = fr.measured_depth_window(campos, rays, near, far, q.z_depth_dim,
                                  rmin, hg.dims, svs)
    # the frame's chunks take SR slots a ray (compact budget 24 = BP), so
    # that M cannot cut a sample: each ray's output is then its exact
    # render, and the frames of two caches compare bit for bit
    cfg_f = dataclasses.replace(cfg, query=dataclasses.replace(
        q, depth_window=dw, compact_budget=q.ray_slot_budget))

    def frame(cache, cf, rm=rmin, sv=svs, params=teacher):
        return [fr.fast_render_rays(
            params, cloud.Rw2c, cache, campos, camrot,
            rays[i * CHUNK:(i + 1) * CHUNK], near, far, cf, rm, sv)
            for i in range(n_ch)]

    def gather(outs):
        cat = {f: torch.cat([getattr(o, f) for o in outs])
               for f in ("coarse_raycolor", "ray_mask", "acc", "depth")}
        ctr = {f: sum(int(getattr(o, f)) for o in outs
                      if getattr(o, f) is not None)
               for f in ("dw_overflow", "rb_overflow", "cb_overflow")}
        return cat, ctr

    captured = {}
    orig_sel = fr.select_first_cols

    def capture_sel(qs_, BP_, cap_, mode_):
        captured.setdefault("qs", (qs_, BP_))
        return orig_sel(qs_, BP_, cap_, mode_)

    fr.select_first_cols = capture_sel
    _cuda.LAUNCHES.clear()
    try:
        outs_h, t_first = timed(lambda: frame(hcache, cfg_f))
    finally:
        fr.select_first_cols = orig_sel
    launch_h = dict(_cuda.LAUNCHES)
    fh, ctr_h = gather(outs_h)
    outs_d, t_first_d = timed(lambda: frame(dcache, cfg_f))
    fd_, ctr_d = gather(outs_d)
    hit = float(fh["ray_mask"].float().mean())
    # the samples the tool's compact budget (8 slots a ray on average)
    # would cut from this frame's chunks: its train batches run at it
    n_valid = [int(o.n_valid_slots) for o in outs_h]
    n_cut = sum(max(0, n - CHUNK * q.compact_budget) for n in n_valid)
    log(f"large scene frame {ROOM_W}x{ROOM_H} (focal {ROOM_FOCAL}, depth "
        f"window {dw} of D {q.z_depth_dim}) on the hash cache: first pass "
        f"{t_first:.2f} s, launches {launch_h}, counters {ctr_h}, ray_mask "
        f"share {hit:.4f}, mean acc {float(fh['acc'].mean()):.4f}; dense "
        f"counters {ctr_d}")
    check_launches("large scene hash frame", launch_h,
                   {"first_valid_cols": n_ch})
    if any(ctr_h.values()) or any(ctr_d.values()):
        fail(f"large scene: non-zero counters {ctr_h} / {ctr_d}")
    if not all(torch.equal(fh[k], fd_[k]) for k in fh):
        fail("large scene: the hash frame differs from the dense frame")
    if not (torch.isfinite(fh["coarse_raycolor"]).all() and hit > 0.5):
        fail(f"large scene: implausible frame (ray_mask share {hit:.4f})")
    qs, BP = captured["qs"]
    sel_k, sel_p = first_valid_cols(qs, BP), first_valid_cols_reference(qs,
                                                                        BP)
    if not all(torch.equal(a, b) for a, b in zip(sel_k, sel_p)):
        fail("large scene: first_valid_cols differs from its plain version")
    t_sel = rotating_ms(lambda x: first_valid_cols(x, BP), qs)
    t_sel_p = cuda_ms(lambda: first_valid_cols_reference(qs, BP), 5, 1)
    b_sel = bound(nbytes(qs) + qs.shape[0] * (BP + 1) * 4, 0)
    # the frames' times: the first passes above, in turns
    frame_ms = {"hash": t_first * 1e3, "dense": t_first_d * 1e3}
    # the lookup alone on chunk 0's window of samples: the hash table's
    # walk against the dense table's gather, device time and the walk's
    # memory beyond its input
    t_w = near + (torch.arange(dw, device=dev, dtype=torch.float32)
                  + 0.5) * ((far - near) / q.z_depth_dim)
    pos0 = campos + rays[:CHUNK, None, :] * t_w[None, :, None]
    qs_h = fr.qslot_lookup(hcache, pos0, rmin, svs)
    if not torch.equal(qs_h, fr.qslot_lookup(dcache, pos0, rmin, svs)):
        fail("large scene: the hash lookup differs from the dense lookup")
    del qs_h
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fr.qslot_lookup(hcache, pos0, rmin, svs)
    torch.cuda.synchronize()
    lookup_bytes = torch.cuda.max_memory_allocated() - base
    lookup_ms = {"hash": cuda_ms(lambda: fr.qslot_lookup(
        hcache, pos0, rmin, svs), 5, 1, queued=True),
                 "dense": cuda_ms(lambda: fr.qslot_lookup(
        dcache, pos0, rmin, svs), 5, 1, queued=True)}
    n_smp = pos0.shape[0] * pos0.shape[1]
    log(f"large scene: the lookup of chunk 0's {n_smp} samples: hash "
        f"{lookup_ms['hash']:.2f} ms, dense {lookup_ms['dense']:.2f} ms "
        f"(queued); the hash walk allocates {lookup_bytes} B at its peak "
        f"({lookup_bytes / n_smp:.1f} B a sample; its output "
        f"{4 * n_smp} B)")
    del pos0
    log(f"large scene: {sum(n_valid)} valid samples ({sum(n_valid) / R:.2f} "
        f"a ray); at the tool's compact budget {q.compact_budget} M would "
        f"cut {n_cut} of them")
    log(f"large scene: hash frame == dense frame bit for bit; frame ms in "
        f"turns: hash {frame_ms['hash']:.1f}, dense {frame_ms['dense']:.1f}, "
        f"hash / dense {frame_ms['hash'] / frame_ms['dense']:.3f} ({smi}); "
        f"first_valid_cols == plain on qs {tuple(qs.shape)}: "
        f"{t_sel:.4f} ms, plain {t_sel_p:.4f} ms, bound {b_sel[0]:.4f} ms")
    if c.prof_dir:
        profile_pass("room_hash_frame", lambda: frame(hcache, cfg_f),
                     frame_ms["hash"], c.prof_dir)

    # ---- fused_decode2 on the hash route, held to the plain decode
    cfg_k = dataclasses.replace(cfg_f, agg=dataclasses.replace(
        cfg.agg, fused_decode2=True))
    orig_kacc = fd.kacc_tower

    def capture_kacc(*a, **k):
        captured.setdefault("kacc", (a, k))
        return orig_kacc(*a, **k)

    fd.kacc_tower = capture_kacc
    _cuda.LAUNCHES.clear()
    try:
        outs_k, t_fk = timed(lambda: frame(hcache, cfg_k))
    finally:
        fd.kacc_tower = orig_kacc
    t_fk *= 1e3
    fk, ctr_k = gather(outs_k)
    launch_k = dict(_cuda.LAUNCHES)
    d_k = (fk["coarse_raycolor"] - fh["coarse_raycolor"]).abs()
    log(f"large scene: hash frame with fused_decode2: launches {launch_k}, "
        f"counters {ctr_k}; against the decode_radiance frame: ray_mask "
        f"equal {bool(torch.equal(fk['ray_mask'], fh['ray_mask']))}, colour "
        f"max |diff| {float(d_k.max()):.3e}, mean {float(d_k.mean()):.3e}")
    if (launch_k.get("fused_decode2", 0) < n_ch
            or launch_k.get("first_valid_cols", 0) != n_ch):
        fail(f"large scene: fused_decode2 / first_valid_cols launches "
             f"{launch_k}")
    if (any(ctr_k.values()) or not torch.equal(fk["ray_mask"], fh["ray_mask"])
            or float(d_k.max()) > ATOL or float(d_k.mean()) >= MEAN_TOL):
        fail("large scene: the fused_decode2 frame disagrees with the plain "
             "decode frame")
    kacc_a, kacc_k = captured["kacc"]
    kacc_err = tower_check("fused_decode2 (room)", fd.kacc_tower,
                           fd.kacc_tower_reference, kacc_a, kacc_k)
    t_ka = cuda_ms(lambda: fd.kacc_tower(*kacc_a, **kacc_k), 10, 2)
    t_ka_p = cuda_ms(lambda: fd.kacc_tower_reference(*kacc_a, **kacc_k), 2, 1)
    b_ka = tower_bound(kacc_a, fd.kacc_tower(*kacc_a, **kacc_k))
    log(f"large scene: fused_decode2 on M={kacc_a[1].shape[0]}: "
        f"{t_ka:.3f} ms, plain {t_ka_p:.3f} ms, bound {b_ka[0]:.4f} ms; "
        f"frame with it {t_fk:.1f} ms")

    # ---- ground truth: 8 train views and 2 held-out views (at half the
    # size, the same field of view) through the dense fused chunk (the
    # teacher's weights)
    def views(poses_, h, w, focal, split):
        intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                        np.float32)
        return BlenderDataset(
            images=np.zeros((len(poses_), h, w, 3), np.float32),
            poses=np.stack(poses_), intrinsics=intr, near=near, far=far,
            split=split)

    ds = views([room_pose(45.0 * v) for v in range(ROOM_VIEWS)], ROOM_H,
               ROOM_W, ROOM_FOCAL, "train")
    ds_eval = views([room_pose(22.5), room_pose(202.5)], ROOM_H // 2,
                    ROOM_W // 2, ROOM_FOCAL / 2, "test")
    cfg_gt = dataclasses.replace(cfg, query=dataclasses.replace(
        q, chunk_mode="fused"))
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    for d in (ds, ds_eval):
        for v in range(d.num_views):
            rv = d.full_image_rays(v)
            o = fr.render_frame(
                teacher, cloud.Rw2c, dcache,
                torch.as_tensor(d.campos(v), device=dev),
                torch.as_tensor(d.camrotc2w(v), device=dev),
                torch.as_tensor(rv, device=dev), near, far, cfg_gt, drmin,
                dsvs, host_rays=rv)
            if any(int(getattr(o, f) or 0) for f in ("dw_overflow",
                                                     "cb_overflow")):
                fail(f"large scene: ground-truth view {v} counters non-zero")
            d.images[v] = o.coarse_raycolor.cpu().numpy().reshape(
                d.images.shape[1:])
    torch.cuda.synchronize()
    launch_gt = dict(_cuda.LAUNCHES)
    n_gt = ds.num_views + ds_eval.num_views
    log(f"large scene: {n_gt} ground-truth views ({ds.num_views} of "
        f"{ROOM_W}x{ROOM_H}, {ds_eval.num_views} held out of "
        f"{ROOM_W // 2}x{ROOM_H // 2}) through the dense fused chunk in "
        f"{time.perf_counter() - t0:.2f} s; launches {launch_gt}")
    if launch_gt.get("fused_chunk_decode", 0) < n_gt:
        fail("large scene: the ground truth did not run the fused chunk")
    del dcache, grid
    torch.cuda.empty_cache()

    # ---- the huge extent: a far cluster 41 m off on every axis
    big = tuple(np.concatenate([a, a[:ROOM_FAR_POINTS]]) for a in arrays)
    big[0][n_pts:] += np.float32(ROOM_FAR_SHIFT)
    far_max = ROOM_FAR_SHIFT + 9.0
    q_big = dataclasses.replace(q, grid_mode="auto", ranges=(
        -3.2, -3.2, -0.2, far_max, far_max, far_max))
    cloud_big = npts.from_arrays(*big, device=dev)
    try:
        gr.build_grid_from_points(cloud_big.xyz, cloud_big.alive, q_big)
        fail("large scene: the dense build took the huge extent")
    except ValueError as e:
        log(f"large scene: the dense build refuses the huge extent ({e})")
    hg_big, t_big = timed(lambda: hgm.build_query_grid(
        cloud_big.xyz, cloud_big.alive, q_big))
    if not isinstance(hg_big, hgm.HashGrid) or not torch.equal(
            hg_big.ranges_min, hg.ranges_min):
        fail("large scene: grid_mode auto did not give the hash grid with "
             "the room's ranges_min")
    cfg_big = dataclasses.replace(cfg, query=q_big)
    hcache_big, big_rmin, big_svs = fr.make_hash_fast_scene(
        cfg_big, cloud_big, hg_big)
    for f in ("kmeta", "kcand", "kxyz"):
        a, b = getattr(hcache_big, f)[:n_q], getattr(hcache, f)[:n_q]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        if not torch.equal(a, b):
            fail(f"large scene: the huge extent's {f} differs from the "
                 f"room's on the room's qslots")
    dw_big = fr.measured_depth_window(campos, rays, near, far,
                                      q.z_depth_dim, big_rmin, hg_big.dims,
                                      big_svs)
    cfg_fb = dataclasses.replace(cfg_big, query=dataclasses.replace(
        q_big, depth_window=dw_big, compact_budget=q.ray_slot_budget))
    fb, ctr_b = gather(frame(hcache_big, cfg_fb, big_rmin, big_svs))
    log(f"large scene: huge extent, dims {hg_big.dims} "
        f"({float(np.prod(hg_big.dims)):.3e} voxels), n_occ "
        f"{int(hg_big.n_occ)}, n_q {int(hg_big.n_q)}, table "
        f"{nbytes(hg_big.table)} B, built in {t_big:.3f} s; its frame at "
        f"depth window {dw_big}: counters {ctr_b}")
    if any(ctr_b.values()) or not all(torch.equal(fb[k], fh[k]) for k in fh):
        fail("large scene: the huge-extent frame differs from the room "
             "frame")
    log("large scene: huge-extent frame == room frame bit for bit; the "
        "room's rows of both caches bit-equal")
    huge = {"dims": list(hg_big.dims), "n_q": int(hg_big.n_q),
            "build_s": t_big, "depth_window": dw_big}
    del hcache_big, hg_big, cloud_big
    torch.cuda.empty_cache()

    # ---- fit() on the hash grid from perturbed weights, and the dense
    # grid from the same start
    student = Aggregator(cfg.agg, seed=0, device=dev)
    with torch.no_grad():
        student.density_head[0].bias += 5.0
        student.color_head[0].bias -= ROOM_COLOUR_SHIFT
    cfg_t = dataclasses.replace(cfg, train=TrainConfig(
        rays_per_batch=TRAIN_RAYS, jitter=0.0, lr_fields=5e-4,
        lr_points=2e-3, fast_path=True, device_sampling=True, prune_iter=0,
        prob_freq=0, march_auto=False))
    runs = {}
    for name, mode, ev in (("hash", "hash", True), ("dense", "dense", False),
                           ("dense_again", "dense", False)):
        out_dir = f"build/room_{name}"
        shutil.rmtree(out_dir, ignore_errors=True)
        cf = dataclasses.replace(cfg_t, query=dataclasses.replace(
            cfg_t.query, grid_mode=mode))
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        # a log record every step (the first step is compared); the
        # logger's own line for each goes to a buffer
        with contextlib.redirect_stdout(io.StringIO()):
            res = loop.fit(cf, ds, student, cloud, out_dir,
                           max_steps=ROOM_STEPS, print_freq=1, save_freq=0,
                           seed=3, device=dev,
                           eval_freq=ROOM_STEPS // 2 if ev else 0,
                           eval_dataset=ds_eval if ev else None,
                           eval_chunk=CHUNK)
        torch.cuda.synchronize()
        shutil.rmtree(out_dir, ignore_errors=True)
        steps_log = [r for r in res.log if "total" in r]
        mloss = [r["ray_masked_coarse_raycolor_loss"] for r in steps_log]
        first = {k: v for k, v in steps_log[0].items() if k != "it_per_sec"}
        runs[name] = dict(
            s=time.perf_counter() - t0, launches=dict(_cuda.LAUNCHES),
            first=first, last_total=steps_log[-1]["total"],
            fall=float(np.mean(mloss[:10]) / np.mean(mloss[-10:])),
            ips=float(np.median([r["it_per_sec"] for r in steps_log[1:]])),
            evals=[(e["step"], e["psnr"], e["wall_s"])
                   for e in res.eval_history])
        r = runs[name]
        log(f"large scene fit {name}: {ROOM_STEPS} steps of {TRAIN_RAYS} rays "
            f"in {r['s']:.1f} s (grid, caches and evaluations included), "
            f"{r['ips']:.2f} it/s (median of the steps' windows); masked "
            f"colour loss steps 1-10 {np.mean(mloss[:10]):.6f} -> steps "
            f"{ROOM_STEPS - 9}-{ROOM_STEPS} {np.mean(mloss[-10:]):.6f} "
            f"({r['fall']:.2f}x); evaluations (step, PSNR, s into the run) "
            f"{r['evals']}; "
            f"launches {r['launches']}")
    h, d1, d2 = runs["hash"], runs["dense"], runs["dense_again"]
    if h["first"] != d1["first"]:
        fail(f"large scene: the first hash step {h['first']} differs from "
             f"the first dense step {d1['first']}")
    gap = abs(h["last_total"] - d1["last_total"])
    gap_dd = abs(d1["last_total"] - d2["last_total"])
    log(f"large scene: first step bit-equal on hash and dense; loss gap "
        f"after {ROOM_STEPS} steps hash - dense {gap:.3e}, dense - dense "
        f"{gap_dd:.3e}")
    if h["fall"] < 2.0 or len(h["evals"]) != 3 or not all(
            np.isfinite(e[1]) for e in h["evals"]):
        fail(f"large scene: fit on the hash grid: the loss fell "
             f"{h['fall']:.2f}x (at least 2x asked), evaluations "
             f"{h['evals']}")
    if h["launches"].get("first_valid_cols", 0) < ROOM_STEPS:
        fail("large scene: first_valid_cols did not run every hash step")
    prof = {}
    if c.prof_dir:
        # one hash train step split into forward, backward and update
        from pointnerf2studio_torch.models import fast_train as ft
        from pointnerf2studio_torch.train.loss import compute_losses
        from pointnerf2studio_torch.train.trainer import (
            apply_updates, create_train_state)
        geo, grmin, gsvs = ft.make_hash_geo_scene(cfg_t, cloud, hg)
        st = create_train_state(student, cloud, cfg_t)
        g = torch.Generator(device=dev).manual_seed(5)
        cp, cr, rd, gt, _ = loop.DeviceSampler(ds, TRAIN_RAYS, g).next_batch()
        near_t = torch.tensor(near, device=dev)
        far_t = torch.tensor(far, device=dev)

        def fwd():
            st.zero_grad()
            return compute_losses(ft.fast_train_render(
                st.params, st.points, geo, cp, cr, rd, near_t, far_t, cfg_t,
                grmin, gsvs, generator=g), gt, cfg_t.train)[0]

        prof = step_profile("room hash train step", fwd,
                            lambda: apply_updates(st, cfg_t), c.prof_dir)
        prof.pop("names", None)
        del geo, st
    peak = max(peak_before, torch.cuda.max_memory_allocated())
    t_total = time.perf_counter() - t_phase
    log(f"large scene phase: {t_total:.1f} s, peak device memory "
        f"{peak} B ({smi})")
    out = {
        "points": n_pts, "dims": list(hg.dims), "n_occ": n_occ, "n_q": n_q,
        "buckets": hg.n_buckets, "table_bytes": nbytes(hg.table),
        "hash_build_s": [t_hash, t_hash2], "dense_build_s": t_dense,
        "cache_bytes": cache_bytes, "cache_s": {"hash": t_hc, "dense": t_dc},
        "depth_window": dw, "valid_samples": sum(n_valid),
        "cut_at_tool_budget": n_cut, "frame_ms": frame_ms,
        "lookup_ms": lookup_ms, "lookup_bytes": lookup_bytes,
        "fused_decode2_frame_ms":
        t_fk, "huge": huge, "peak_bytes": peak, "s": t_total,
        "fit": {k: {x: v[x] for x in ("s", "ips", "fall", "evals",
                                      "last_total")}
                for k, v in runs.items()},
        "loss_gap": {"hash_dense": gap, "dense_dense": gap_dd},
        "select": dict(launches=launch_h["first_valid_cols"]
                       + h["launches"].get("first_valid_cols", 0),
                       frame=launch_h["first_valid_cols"],
                       fit=h["launches"].get("first_valid_cols", 0),
                       ms=t_sel, plain_ms=t_sel_p, bound_ms=b_sel[0],
                       qs=list(qs.shape)),
        "kacc": dict(launches=launch_k["fused_decode2"], ms=t_ka,
                     plain_ms=t_ka_p, bound_ms=b_ka[0], max_abs_err=kacc_err,
                     M=kacc_a[1].shape[0]),
        "chunk_gt": launch_gt.get("fused_chunk_decode", 0),
        "profile_train_step": prof,
    }
    del hcache, hg, cloud
    torch.cuda.empty_cache()
    return out


def plane_phase(c) -> dict:
    """The plane background on the chair (section "plane" of the module
    docstring). Returns the phase's numbers and its launches."""
    import torch
    from pointnerf2studio_torch.config import TrainConfig
    from pointnerf2studio_torch.data.blender import BlenderDataset
    from pointnerf2studio_torch.models import bg_plane as bp
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models.aggregator import Aggregator
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.evaluator import evaluate_dataset

    scene, dev, smi = c.scene, c.dev, c.smi
    t_phase = time.perf_counter()
    near, far = scene.near, scene.far
    hw, foc = PLANE_HW, PLANE_FOCAL
    pnt = torch.tensor(PLANE_PNT, device=dev)
    normal = torch.tensor(PLANE_NORMAL, device=dev)
    colour = torch.tensor(PLANE_COLOUR, device=dev)
    bg0 = torch.tensor(c.cfg.bg_color, device=dev)
    poses = np.stack([orbit_pose(30.0 + 90.0 * v) for v in range(4)])
    intr = np.array([[foc, 0, hw / 2], [0, foc, hw / 2], [0, 0, 1]],
                    np.float32)
    ds = BlenderDataset(images=np.zeros((4, hw, hw, 3), np.float32),
                        poses=poses, intrinsics=intr, near=near, far=far,
                        split="train")
    # ---- the dataset: teacher renders through the fused chunk, composited
    # over the plane wherever a ray meets it
    cfg_f = dataclasses.replace(c.cfg, query=dataclasses.replace(
        c.cfg.query, depth_window=0, ray_budget=0))
    plane_px = []
    _cuda.LAUNCHES.clear()
    for v in range(4):
        rv = ds.full_image_rays(v)
        rays = torch.as_tensor(rv, device=dev)
        campos = torch.as_tensor(ds.campos(v), device=dev)
        o = fr.render_frame(
            scene.params, scene.cloud.Rw2c, c.cache, campos,
            torch.as_tensor(ds.camrotc2w(v), device=dev), rays, near, far,
            cfg_f, c.rmin, c.svs, host_rays=rv)
        meets = bp.ray_plane_intersection(campos, rays, pnt, normal)[1]
        gt = o.coarse_raycolor + torch.where(
            meets[:, None], (1 - o.acc)[:, None] * (colour - bg0), 0.0)
        ds.images[v] = gt.cpu().numpy().reshape(hw, hw, 3)
        plane_px.append(meets.cpu().numpy().reshape(hw, hw))
    launch_gt = dict(_cuda.LAUNCHES)
    plane_px = np.stack(plane_px)
    if launch_gt.get("fused_chunk_decode", 0) < 4:
        fail(f"plane: the teacher views did not run the fused chunk "
             f"({launch_gt})")

    # ---- the maps on the card and on the host
    cfg_p = dataclasses.replace(
        c.train_setup["cfg"], bgmodel="plane", bg_plane_pnt=PLANE_PNT,
        bg_plane_normal=PLANE_NORMAL, bg_plane_color=PLANE_COLOUR)
    fg = scene.cloud.xyz[scene.cloud.alive]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = bp.create_all_bg(cfg_p, ds, points_xyz=fg, device=dev)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    maps_cpu = bp.create_all_bg(cfg_p, ds, points_xyz=fg.cpu(),
                                device="cpu")
    t_cpu = time.perf_counter() - t0
    diff = np.abs(maps - maps_cpu).max(-1)
    flips = int((diff > 1e-5).sum())
    valid = (maps != np.asarray(c.cfg.bg_color, np.float32)).any(-1)
    share = float(valid[plane_px].mean())
    log(f"plane: maps of 4 views {hw}x{hw} in {t_gpu:.2f} s on the card, "
        f"{t_cpu:.2f} s on the host; {flips} of {diff.size} pixels differ "
        f"by more than 1e-5 (ceil flips; "
        f"{flips / diff.size:.2e}), the others within "
        f"{float(np.where(diff > 1e-5, 0, diff).max()):.2e}; "
        f"{int(plane_px.sum())} pixels meet the plane, {share:.3f} of them "
        f"valid; teacher launches {launch_gt}")
    if flips > 1e-3 * diff.size or share < 0.5:
        fail("plane: the maps disagree with the host's or cover too little "
             "of the plane")

    # ---- fit() on the fast and the legacy step with the plane
    student = Aggregator(c.cfg.agg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        student.density_head[0].bias += 5.0
        for p in student.parameters():
            p += PLANE_PERTURB * p.std(correction=0) * torch.randn(
                p.shape, generator=gen, device=dev)
    base_t = dataclasses.replace(cfg_p.train, jitter=0.0, march_auto=False)
    cfg_fast = dataclasses.replace(cfg_p, train=base_t)
    cfg_leg = dataclasses.replace(
        cfg_p, query=dataclasses.replace(
            cfg_p.query, use_cache=True, compact_budget=0,
            max_q=c.cache.max_q),
        agg=dataclasses.replace(cfg_p.agg, fused_decode=True),
        train=dataclasses.replace(base_t, fast_path=False))
    fits = {}
    for name, cf in (("fast", cfg_fast), ("legacy", cfg_leg)):
        out_dir = f"build/plane_{name}"
        shutil.rmtree(out_dir, ignore_errors=True)
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = loop.fit(cf, ds, student, scene.cloud, out_dir,
                       max_steps=PLANE_STEPS, print_freq=10, save_freq=0,
                       seed=3, device=dev,
                       eval_dataset=ds if name == "legacy" else None,
                       eval_views=[0], eval_chunk=4096)
        torch.cuda.synchronize()
        shutil.rmtree(out_dir, ignore_errors=True)
        steps_log = [r for r in res.log if "total" in r]
        first, last = steps_log[0]["total"], steps_log[-1]["total"]
        fits[name] = dict(first=first, last=last,
                          s=time.perf_counter() - t0,
                          launches=dict(_cuda.LAUNCHES),
                          evals=[(e["step"], e["psnr"])
                                 for e in res.eval_history], state=res.state)
        log(f"plane fit {name}: {PLANE_STEPS} steps in "
            f"{fits[name]['s']:.1f} s; loss steps 1-10 {first:.6f} -> "
            f"steps {PLANE_STEPS - 9}-{PLANE_STEPS} {last:.6f} "
            f"({first / last:.2f}x); evaluations {fits[name]['evals']}; "
            f"launches {fits[name]['launches']}")
        if not last < first:
            fail(f"plane fit {name}: the loss did not fall")
    if fits["legacy"]["launches"].get("fused_decode", 0) < 1:
        fail("plane: the legacy evaluation did not run fused_decode")
    st = fits["fast"].pop("state")
    fits["legacy"].pop("state")
    cfg_e = dataclasses.replace(c.cfg, bgmodel="plane",
                                bg_plane_pnt=PLANE_PNT,
                                bg_plane_normal=PLANE_NORMAL,
                                bg_plane_color=PLANE_COLOUR)
    _cuda.LAUNCHES.clear()
    m = evaluate_dataset(cfg_e, st.params, st.points, scene.grid, ds,
                         views=[0], chunk=CHUNK, fast=True,
                         bg_src_dataset=ds)
    launch_e = dict(_cuda.LAUNCHES)
    log(f"plane: view 0 after the fast fit through render_frame and the "
        f"fused chunk: PSNR {m['psnr']:.2f} dB; launches {launch_e}")
    if launch_e.get("fused_chunk_decode", 0) < 1 or not np.isfinite(
            m["psnr"]):
        fail("plane: the fast evaluation did not run the fused chunk")
    t_total = time.perf_counter() - t_phase
    log(f"plane phase: {t_total:.1f} s ({smi})")
    return {"maps_s": {"card": t_gpu, "host": t_cpu}, "ceil_flips": flips,
            "pixels": int(diff.size), "plane_valid_share": share,
            "fit": fits, "fast_eval_psnr": m["psnr"],
            "launches": {"teacher": launch_gt, "fast_eval": launch_e},
            "s": t_total}


def write_ply(path, xyz, rgb) -> None:
    """A binary PLY of float xyz and 8-bit colour (what `load_ply` reads)."""
    rec = np.zeros(xyz.shape[0],
                   dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = xyz
    rec["rgb"] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex "
                 f"{xyz.shape[0]}\nproperty float x\nproperty float y\n"
                 "property float z\nproperty uchar red\nproperty uchar "
                 "green\nproperty uchar blue\nend_header\n").encode())
        rec.tofile(f)


def run_cli(argv, phase: str = "data", expect: str = "") -> str:
    """`cli.main(argv)` in this process, its standard output captured and
    logged; a failure of the command fails the run, except a ValueError
    whose message holds `expect` (where given), which is logged (the
    command may also succeed)."""
    from pointnerf2studio_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    raised = None
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except ValueError as e:
            if not expect or expect not in str(e):
                raise
            raised = e
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    log(f"{phase}: cli {argv[0]} in {time.perf_counter() - t0:.1f} s: "
        + (" | ".join(lines[-3:]) if lines else "(no output)")
        + (f" | raised as expected: {raised}" if raised else ""))
    return text


def data_config():
    """The chair preset at full width as the data phase trains it: bf16
    aggregator, D 400, the kernel routes, no pruning or growth, 4,096-ray
    legacy steps."""
    from pointnerf2studio_torch.data.presets import nerf_synth_config
    cfg = nerf_synth_config("chair")
    return dataclasses.replace(
        cfg,
        query=dataclasses.replace(cfg.query, z_depth_dim=400,
                                  ray_slot_budget=32, fast_chunk=4096,
                                  select_mode="pallas"),
        agg=dataclasses.replace(cfg.agg, compute_dtype="bfloat16",
                                fused_decode=True),
        train=dataclasses.replace(cfg.train, prob_freq=0, prune_iter=0,
                                  rays_per_batch=TRAIN_RAYS))


def data_phase(c) -> dict:
    """The user's data path and entry point on the procedural chair
    (section "data" of the module docstring). Returns the phase's numbers
    and its launches."""
    import ast
    import importlib.util

    import torch
    from pointnerf2studio_torch.data import procedural as proc
    from pointnerf2studio_torch.data.blender import load_blender
    from pointnerf2studio_torch.data.pointcloud_init import (
        init_cloud_from_points, init_points_from_depth)
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.models.aggregator import Aggregator
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import fused_decode as fd
    from pointnerf2studio_torch.ops import select as sl
    from pointnerf2studio_torch.ops.fused_chunk import (
        fused_chunk_decode_plain)
    from pointnerf2studio_torch.ops.hash_grid import build_query_grid
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.evaluator import (
        make_fast_frame_renderer, make_render_chunk_fn, render_image)

    dev, smi = c.dev, c.smi
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = pathlib.Path("build/data")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = root / "chair"
    has_pil = importlib.util.find_spec("PIL") is not None
    has_imageio = importlib.util.find_spec("imageio") is not None
    log(f"data: PIL {'present' if has_pil else 'missing'}, imageio "
        f"{'present' if has_imageio else 'missing'} on this machine")
    if not has_pil:
        fail("data: PIL is missing: generate_chair_dataset and load_blender "
             "need it")
    hw = (DATA_HW, DATA_HW)
    focal = proc.chair_focal(DATA_HW)

    # ---- 1. the dataset, traced on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proc.generate_chair_dataset(
        str(data_dir), n_train=DATA_TRAIN, n_test=DATA_TEST, hw=hw, seed=0,
        save_depth=True, style="v2", ss=2, device=dev)
    t_gen = time.perf_counter() - t0
    train_ds = load_blender(str(data_dir), "train")
    test_ds = load_blender(str(data_dir), "test")
    depths = np.stack([np.load(data_dir / "train" / f"depth_{k}.npy")
                       for k in range(DATA_TRAIN)])
    log(f"data: chair v2, ss 2, {DATA_HW}x{DATA_HW}, {DATA_TRAIN} train / "
        f"{DATA_TEST} test views with depth, seed 0, traced on the card in "
        f"{t_gen:.2f} s; generate_chair_dataset wrote it, load_blender read "
        f"it")
    if not (np.isfinite(train_ds.images).all() and depths.shape
            == (DATA_TRAIN, DATA_HW, DATA_HW) and (depths > 0).any()):
        fail("data: the dataset is not finite or has no depth")
    # one view on the card and on the host, at the traced (supersampled)
    # resolution: the hit masks and the colour of the rays both hit
    cam0 = proc.chair_cameras(DATA_TRAIN, DATA_TEST, seed=0)["test"][0]
    dirs0 = proc._camera_dirs(cam0, 2 * DATA_HW, 2 * DATA_HW, 2 * focal)
    org0 = cam0[:3, 3].astype(np.float32)
    t0 = time.perf_counter()
    rgba_d = proc._march_rays(torch.as_tensor(org0, device=dev),
                              torch.as_tensor(dirs0, device=dev), 128,
                              "v2").cpu().numpy()
    t_dev_view = time.perf_counter() - t0
    t0 = time.perf_counter()
    rgba_h = proc._march_rays(torch.as_tensor(org0), torch.as_tensor(dirs0),
                              128, "v2").numpy()
    t_host_view = time.perf_counter() - t0
    hit_d, hit_h = rgba_d[:, 3] > 0, rgba_h[:, 3] > 0
    n_mask_diff = int((hit_d != hit_h).sum())
    both = hit_d & hit_h
    col_diff = float(np.abs(rgba_d - rgba_h)[both].max())
    log(f"data: test view 0 traced at {2 * DATA_HW}x{2 * DATA_HW} rays on "
        f"the card ({t_dev_view:.2f} s) and on the host ({t_host_view:.2f} "
        f"s): {n_mask_diff} of {hit_d.size} rays differ in their hit mask, "
        f"largest colour difference on the {int(both.sum())} rays both hit "
        f"{col_diff:.3e}")
    close = float((np.abs(rgba_d - rgba_h)[both].max(-1) <= 2e-4).mean())
    log(f"data: {close:.6f} of the rays both hit agree within 2e-4")
    if n_mask_diff > 5e-3 * hit_d.size or close < 0.995:
        fail("data: the card's trace of a view disagrees with the host's")

    # ---- 2. the point cloud from the depth maps (validate_chair --init
    # depth)
    cfg = data_config()
    t0 = time.perf_counter()
    xyz, colour = init_points_from_depth(
        depths, train_ds.poses, train_ds.intrinsics, images=train_ds.images,
        stride=2, max_depth=6.0)
    cloud = init_cloud_from_points(
        xyz, colour, feat_dim=cfg.agg.point_features_dim,
        feature_init_method="rand", default_conf=0.3, vox_res=320,
        ranges=cfg.query.ranges, device=dev)
    n_pts = int(cloud.num_alive)
    t_init = time.perf_counter() - t0
    log(f"data: {xyz.shape[0]} depth points, {n_pts} after the vox_res 320 "
        f"downsample in {t_init:.2f} s (the JAX record: {DATA_JAX_POINTS})")

    # ---- 3. fit(): the legacy step through first_valid_cols, evaluation
    # through fused_decode
    params = Aggregator(cfg.agg, seed=0, device=dev)
    run_dir = root / "run"
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.fit(cfg, train_ds, params, cloud, str(run_dir),
                   max_steps=DATA_STEPS, print_freq=100, save_freq=0,
                   eval_dataset=test_ds, eval_views=[0, 1],
                   eval_freq=DATA_EVAL_FREQ, seed=0, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fit_launches = dict(_cuda.LAUNCHES)
    ips = sorted(r["it_per_sec"] for r in res.log[1:]
                 if "total" in r and r["it_per_sec"] > 0)
    curve = [(e["step"], round(e["psnr"], 4)) for e in res.eval_history]
    ttp = res.time_to_psnr(DATA_TARGET_DB)
    n_evals = len(res.eval_history)
    chunks = -(-DATA_HW * DATA_HW // 4096)
    want_sel = DATA_STEPS + n_evals * 2 * chunks
    log(f"data: fit {DATA_STEPS} legacy steps of {TRAIN_RAYS} rays in "
        f"{t_fit:.1f} s, {ips[len(ips) // 2]:.2f} it/s (median of "
        f"{len(ips)} windows of 100 steps after the first; spread "
        f"{ips[0]:.2f}-{ips[-1]:.2f}; {smi})")
    log(f"data: held-out PSNR of test views 0-1 by step {curve} (the JAX "
        f"record on this scene: {DATA_JAX_RECORD[1]} dB at step "
        f"{DATA_JAX_RECORD[0]}, 25.03 at 10,000); time to "
        f"{DATA_TARGET_DB:g} dB: "
        + ("not reached" if ttp is None else
           f"step {ttp[0]}, {ttp[1]:.1f} s of fit()'s wall time"))
    log(f"data: fit launches {fit_launches}: first_valid_cols "
        f"{DATA_STEPS} steps + {n_evals} evaluations x 2 views x {chunks} "
        f"chunks = {want_sel} expected")
    check_launches("data fit", fit_launches,
                   {"first_valid_cols": want_sel, "fused_chunk_decode": 0})
    if fit_launches.get("fused_decode", 0) < n_evals * 2:
        fail("data: the legacy evaluations did not run fused_decode")
    psnrs = [p for _, p in curve]
    if not (all(np.isfinite(psnrs)) and psnrs[-1] > psnrs[0]):
        fail(f"data: the held-out PSNR did not rise ({curve})")
    state = res.state

    # ---- 4. #5 and #3 against their plain routes on the trained chair
    v = 0
    rays_v = test_ds.full_image_rays(v)
    cp, cr = test_ds.campos(v), test_ds.camrotc2w(v)
    cfg_f = dataclasses.replace(cfg, query=dataclasses.replace(
        cfg.query, chunk_mode="fused"))
    grid = build_query_grid(state.points.xyz, state.points.alive, cfg.query)
    frame = make_fast_frame_renderer(cfg_f, state.points, grid,
                                     test_ds.near, test_ds.far)

    def fused_route(plain):
        orig = fr.fused_chunk_decode
        if plain:
            fr.fused_chunk_decode = fused_chunk_decode_plain
        try:
            with torch.no_grad():
                o = frame(state.params, cp, cr, rays_v)
        finally:
            fr.fused_chunk_decode = orig
        return o.coarse_raycolor, o.ray_mask

    legacy_chunk = make_render_chunk_fn(cfg)

    def legacy_route(plain):
        orig = lr.first_valid_cols, lr.fused_decode
        if plain:
            lr.first_valid_cols = sl.first_valid_cols_reference
            lr.fused_decode = fd.fused_decode_reference
        try:
            o = render_image(legacy_chunk, state.params, state.points, grid,
                             cp, cr, rays_v, test_ds.hw, test_ds.near,
                             test_ds.far, 4096)
        finally:
            lr.first_valid_cols, lr.fused_decode = orig
        return (torch.as_tensor(o["coarse_raycolor"]).reshape(-1, 3),
                torch.as_tensor(o["ray_mask"]).reshape(-1))

    checks = {}
    for name, route, kernel in (("fused chunk", fused_route,
                                 "fused_chunk_decode"),
                                ("legacy", legacy_route, "fused_decode")):
        _cuda.LAUNCHES.clear()
        col_k, m_k = route(False)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        col_p, m_p = route(True)
        d = (col_k.float() - col_p.float()).abs()
        checks[name] = {"launches": launches, "max_abs_err": float(d.max()),
                        "mean_abs_err": float(d.mean()),
                        "hit_rays": int(m_k.sum())}
        log(f"data: test view 0 on the trained chair through {name} "
            f"({kernel}) against its plain route: ray_mask "
            f"{'equal' if torch.equal(m_k, m_p) else 'DIFFERS'} "
            f"({int(m_k.sum())} hit rays), colour max |diff| "
            f"{float(d.max()):.3e}, mean {float(d.mean()):.3e}; launches "
            f"{launches}")
        if launches.get(kernel, 0) < 1:
            fail(f"data: the {name} route did not launch {kernel}")
        if not torch.equal(m_k, m_p):
            fail(f"data: {name}: ray_mask differs between kernel and plain")
        if not (float(d.max()) <= ATOL and float(d.mean()) < MEAN_TOL):
            fail(f"data: {name}: colour outside {ATOL} / mean {MEAN_TOL}")
    del frame, grid

    # ---- 5. the command line on the trained state, on the card
    ckpt = run_dir / f"{DATA_STEPS}_net_ray_marching.pth"
    if not ckpt.is_file():
        fail(f"data: fit() did not export {ckpt}")
    common = ["--scene", "chair", "--data", str(data_dir)]
    cli_out = {}
    _cuda.LAUNCHES.clear()
    t_cli = time.perf_counter()
    for key, extra in (("eval", ["--out", str(root / "eval")]),
                       ("eval_fast", ["--fast"])):
        text = run_cli(["eval", *common, "--checkpoint", str(run_dir),
                        "--eval-views", "2", *extra])
        cli_out[key] = ast.literal_eval(text.strip().splitlines()[-1])
    log(f"data: cli eval PSNR {cli_out['eval']['psnr']:.4f} dB (the "
        f"preset's legacy route, float32), eval --fast "
        f"{cli_out['eval_fast']['psnr']:.4f} dB (the preset's XLA "
        f"route); fit()'s last evaluation {psnrs[-1]:.4f} dB (bf16, "
        f"the kernel routes)")
    if has_imageio:
        gif = root / "orbit.gif"
        run_cli(["render-video", *common, "--checkpoint", str(run_dir),
                 "--fast", "--frames", "8", "--out", str(gif)])
        if not gif.is_file():
            fail("data: render-video wrote no GIF")
    else:
        log("data: imageio is missing: render-video not run")
    # the ground truth as the evaluation saw it: the test views
    # composited onto white, as 8-bit PNGs. Not the dataset's own test
    # PNGs: they are RGBA, and evaluate-images reads their RGB alone, on
    # a black background (the reference's utils/metrics.py:148-149 does
    # the same), which reads near 1 dB on this chair (ROADMAP section 3)
    from pointnerf2studio_torch.train.evaluator import save_image
    gt_dir = root / "gt"
    for k in range(2):
        save_image(test_ds.images[k], str(gt_dir / f"gt_{k:03d}.png"))
    text = run_cli(["evaluate-images", "--pred", str(root / "eval"),
                    "--gt", str(gt_dir)])
    cli_out["evaluate_images"] = json.loads(text.strip().splitlines()[-1])
    log(f"data: evaluate-images PSNR "
        f"{cli_out['evaluate_images']['psnr']:.4f} dB over the 8-bit "
        f"eval output beside eval's {cli_out['eval']['psnr']:.4f} dB")
    if abs(cli_out["evaluate_images"]["psnr"]
           - cli_out["eval"]["psnr"]) > 0.5:
        fail("data: evaluate-images disagrees with eval")
    # the recorded fault: the same command over the dataset's own test
    # PNGs of the two views, read as RGB on black
    rgba_dir = root / "gt_rgba"
    rgba_dir.mkdir()
    for k in range(2):
        shutil.copy(data_dir / "test" / f"r_{k}.png", rgba_dir)
    text = run_cli(["evaluate-images", "--pred", str(root / "eval"),
                    "--gt", str(rgba_dir)])
    cli_out["evaluate_images_rgba_gt"] = json.loads(
        text.strip().splitlines()[-1])
    log(f"data: evaluate-images over the dataset's own RGBA test PNGs: "
        f"{cli_out['evaluate_images_rgba_gt']['psnr']:.4f} dB (a fault of "
        f"both packages' metrics_over_dirs, recorded, not checked)")
    run_cli(["visualize", "--checkpoint", str(run_dir), "--out",
             str(root / "viz")])
    if not (root / "viz" / "points.ply").is_file():
        fail("data: visualize wrote no PLY")
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (2.0, 0.0, 0.0)
    np.save(root / "identity.npy", np.eye(4, dtype=np.float32))
    np.save(root / "shift.npy", shift)
    merged_path = root / "edit" / "merged.pth"
    run_cli(["edit", "--parts", str(ckpt), str(ckpt), "--transforms",
             str(root / "identity.npy"), str(root / "shift.npy"), "--out",
             str(merged_path)])
    merged = torch.load(merged_path, map_location="cpu", weights_only=True)
    n_alive = int(state.points.num_alive)
    n_merged = merged["neural_points.xyz"].shape[0]
    log(f"data: edit merged {n_merged} points from 2 x {n_alive} alive")
    if n_merged != 2 * n_alive:
        fail("data: the edited scene does not hold both parts")
    ply = root / "depth_cloud.ply"
    write_ply(ply, xyz, colour)
    gp_dir = root / "gen_points"
    run_cli(["gen-points", *common, "--from-ply", str(ply), "--out",
             str(gp_dir)])
    run_cli(["train", *common, "--point-cloud", str(gp_dir), "--out",
             str(root / "cli_train"), "--max-steps", "20"])
    if not (root / "cli_train" / "20_net_ray_marching.pth").is_file():
        fail("data: cli train wrote no checkpoint at step 20")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t_cli
    cli_launches = dict(_cuda.LAUNCHES)
    log(f"data: the commands took {t_cli:.1f} s; launches {cli_launches} "
        f"(the preset's routes run first_valid_cols in the legacy "
        f"compaction and no other kernel)")
    t_total = time.perf_counter() - t_phase
    log(f"data phase: {t_total:.1f} s ({smi})")
    return {"imageio": has_imageio, "dataset_s": t_gen,
            "view_trace": {"card_s": t_dev_view, "host_s": t_host_view,
                           "mask_differs": n_mask_diff,
                           "rays": int(hit_d.size),
                           "max_colour_diff": col_diff,
                           "share_within_2e-4": close},
            "points": n_pts, "depth_points": int(xyz.shape[0]),
            "fit": {"s": t_fit, "it_per_sec": ips[len(ips) // 2],
                    "it_per_sec_spread": [ips[0], ips[-1]],
                    "psnr_curve": curve,
                    "time_to_psnr": (None if ttp is None else
                                     {"db": DATA_TARGET_DB, "step": ttp[0],
                                      "wall_s": ttp[1]}),
                    "final_psnr": psnrs[-1]},
            "checks": checks,
            "cli": {k: v for k, v in cli_out.items()}, "cli_s": t_cli,
            "launches": {"fit": fit_launches, "cli": cli_launches,
                         **{k: v["launches"] for k, v in checks.items()}},
            "s": t_total}


def cloud_match(got, want):
    """Points of cloud `got` without a point of `want` within 1e-5 of the
    scale, and the other way round; the largest difference of each
    attribute over the matched points, relative to its scale."""
    from scipy.spatial import cKDTree
    tol = 1e-5 * max(1.0, float(np.abs(want["xyz"]).max()))
    d, j = cKDTree(want["xyz"]).query(got["xyz"])
    ok = d <= tol
    d2, _ = cKDTree(got["xyz"]).query(want["xyz"])
    errs = {}
    for k in ("embedding", "color", "dir", "conf"):
        a, b = got[k][ok], want[k][j[ok]]
        errs[k] = (float(np.abs(a - b).max())
                   / max(1.0, float(np.abs(b).max()))) if b.size else 0.0
    return int((~ok).sum()), int((d2 > tol).sum()), errs


def mvs_phase(c, data) -> dict:
    """MVSNet point generation and joint MVS training on the chair-data
    dataset (section "mvs" of the module docstring). Returns the phase's
    numbers and its launches."""
    import copy

    import torch
    from pointnerf2studio_torch.data.blender import load_blender
    from pointnerf2studio_torch.data.mvs_batches import build_view_batches
    from pointnerf2studio_torch.data.presets import get_preset
    from pointnerf2studio_torch.models import neural_points as npts
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.models.aggregator import Aggregator
    from pointnerf2studio_torch.models.mvsnet import featurenet as mf
    from pointnerf2studio_torch.models.mvsnet import mvsnet as mm
    from pointnerf2studio_torch.models.mvsnet import pointgen as mp
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops import select as sl
    from pointnerf2studio_torch.ops.grid import compute_grid_geometry
    from pointnerf2studio_torch.ops.hash_grid import build_query_grid
    from pointnerf2studio_torch.train import joint as tj
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.evaluator import (
        make_render_chunk_fn, render_image)
    from pointnerf2studio_torch.utils import lpips as lp

    dev, smi = c.dev, c.smi
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = pathlib.Path("build/mvs")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    data_dir = pathlib.Path("build/data/chair")
    train_ds = load_blender(str(data_dir), "train")
    test_ds = load_blender(str(data_dir), "test")
    depths = np.stack([np.load(data_dir / "train" / f"depth_{k}.npy")
                       for k in range(DATA_TRAIN)])
    mvs_ckpt = mm.random_mvsnet_checkpoint(
        str(root / "model_000014.ckpt"), 0)
    fpn_ckpt = mf.random_fpn_checkpoint(str(root / "best_net_mvs.pth"), 1)
    nets = {d: (mm.load_mvsnet_params(mvs_ckpt, device=d),
                mf.load_fpn_params(fpn_ckpt, device=d))
            for d in (dev, torch.device("cpu"))}
    host = torch.device("cpu")
    batches, alphas, aK, aE = build_view_batches(train_ds, num_src=2)
    for i, vb in enumerate(batches):
        vb.gt_depth = depths[i]      # "nearest": batch i's ref is view i
    cfg = data_config()
    log(f"mvs: random reference-layout weights (model_000014.ckpt and "
        f"best_net_mvs.pth layouts, seeds 0 and 1) loaded by the port's "
        f"loaders; {len(batches)} view batches of 3 views of "
        f"{DATA_HW}x{DATA_HW} (num_src 2, nearest pairing)")

    # ---- 1. mvsnet_depth at full width on view batch 0: 400x400 views,
    # 100x100 features, MVS_BINS planes
    vb = batches[0]
    proj = mp.rel_proj_mats(mp.quarter_intrinsics(vb.intrinsics), vb.w2cs)
    dmin, dmax = vb.near_far_depth
    dvals = dmin + np.arange(MVS_BINS, dtype=np.float32) * (
        (dmax - dmin) / MVS_BINS)

    def inputs(d):
        return [torch.as_tensor(np.asarray(a, np.float32), device=d)
                for a in (vb.images, proj, dvals)]

    a_d, a_h = inputs(dev), inputs(host)
    net_d = nets[dev][0]
    with torch.no_grad():
        mm.mvsnet_depth(net_d, *a_d)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out_d = mm.mvsnet_depth(net_d, *a_d)
        torch.cuda.synchronize()
        peak_depth = torch.cuda.max_memory_allocated() - base
        t_depth = sorted(cuda_ms(lambda: mm.mvsnet_depth(net_d, *a_d), 1, 0)
                         for _ in range(5))[2]
        var = mm.variance_volume(net_d, *a_d)
        t_cv = sum(r[0] for r in device_rows(
            lambda: mm.variance_volume(net_d, *a_d))) or None
        t_unet = sum(r[0] for r in device_rows(
            lambda: mm.cost_reg_net(net_d.cost_regularization, var))) or None
        del var
        t0 = time.perf_counter()
        out_h = mm.mvsnet_depth(nets[host][0], *a_h)
        t_depth_cpu = time.perf_counter() - t0

    def didx(prob):
        ar = torch.arange(MVS_BINS, dtype=torch.float32, device=prob.device)
        return (prob * ar[:, None, None]).sum(0).to(torch.int64).cpu()

    di_d, di_h = didx(out_d[2]), didx(out_h[2])
    same = di_d == di_h
    d_d, c_d, p_d = (x.cpu() for x in out_d)
    d_h, c_h, p_h = out_h
    e_depth = float((d_d - d_h).abs().max())
    e_prob = float((p_d - p_h).abs().max())
    e_conf = float((c_d - c_h).abs()[same].max())
    n_didx = int((~same).sum())
    depth_rec = {"hw": list(d_d.shape), "bins": MVS_BINS, "ms": t_depth,
                 "cost_volume_ms": t_cv, "unet_ms": t_unet,
                 "peak_bytes": int(peak_depth), "cpu_s": t_depth_cpu,
                 "max_depth_err": e_depth, "max_prob_err": e_prob,
                 "didx_differ": n_didx, "max_conf_err_where_same": e_conf}
    log(f"mvs: mvsnet_depth on view batch 0 at full width ({DATA_HW}x"
        f"{DATA_HW} views, {tuple(d_d.shape)} features, {MVS_BINS} planes): "
        f"{t_depth:.2f} ms on the card (median of 5 warm calls; by the "
        f"profiler the cost-volume build {ms_text(t_cv, 2)} ms, the 3-D "
        f"U-Net {ms_text(t_unet, 2)} ms), peak {peak_depth} B above the inputs; the host "
        f"{t_depth_cpu:.2f} s; card vs host: depth max |diff| "
        f"{e_depth:.3e}, prob {e_prob:.3e}, expectation index apart on "
        f"{n_didx} of {same.numel()} pixels, confidence where it agrees "
        f"{e_conf:.3e} ({smi})")
    if not (e_depth <= 1e-4 * float(dmax) and e_prob <= 1e-4
            and n_didx <= 0.01 * same.numel() and e_conf <= 1e-4):
        fail("mvs: mvsnet_depth on the card disagrees with the host")
    del out_d, out_h, a_d, a_h

    # ---- 2. generate_point_cloud over every view batch, in both modes;
    # the card against the host on the first MVS_CPU_BATCHES
    def generate(d, bs, mode):
        st = {}
        pg = mp.PointGenConfig(vox_res=320, ranges=cfg.query.ranges,
                               depth_mode=mode)
        try:
            pc = mp.generate_point_cloud(*nets[d], bs, alphas=alphas,
                                         alpha_intrinsics=aK,
                                         alpha_w2cs=aE, cfg=pg, stats=st)
        except ValueError as e:
            if "no point survived" not in str(e):
                raise
            pc = None
        return pc, st

    gen_rec = {}
    for mode in ("mvsnet", "gt"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc, st = generate(dev, batches, mode)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        shares = {k: st[k] / st["pixels"] for k in
                  ("depth_in_range", "conf_above", "filtered",
                   "alpha_kept") if k in st}
        n = 0 if pc is None else int(pc["xyz"].shape[0])
        gen_rec[mode] = {"s": t_gen, "points": n, "stats": st,
                         "shares": shares}
        log(f"mvs: generate_point_cloud, {mode} mode, {len(batches)} "
            f"batches in {t_gen:.2f} s: shares of the {st['pixels']} "
            f"pixels kept by the depth range, the confidence gate, the "
            f"fused filter (gate, >= 2 consistent views, ranges) and the "
            f"alpha hull: "
            + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
            + f"; {n} points after vox_res 320"
            + (" (none survived: the port raises there)" if pc is None
               else ""))
        if mode == "gt":
            pc_gt = pc
    if pc_gt is None:
        fail("mvs: the gt-mode cloud is empty")
    log(f"mvs: the gt-mode cloud has {pc_gt['xyz'].shape[0]} points beside "
        f"the data phase's depth initialisation of {data['points']} "
        f"(PERF.md: 136,187)")
    flips = {}
    for mode in ("mvsnet", "gt"):
        (pc_d, st_d), (pc_h, st_h) = (generate(d, batches[:MVS_CPU_BATCHES],
                                               mode) for d in (dev, host))
        n_d = 0 if pc_d is None else pc_d["xyz"].shape[0]
        n_h = 0 if pc_h is None else pc_h["xyz"].shape[0]
        bound_ = max(8, int(np.ceil(1e-2 * max(n_d, n_h))))
        st_diff = {k: st_d.get(k, 0) - st_h.get(k, 0) for k in st_h}
        rec = {"points": [n_d, n_h], "stage_diff": st_diff,
               "flip_bound": bound_}
        if pc_d is not None and pc_h is not None:
            u_d, u_h, errs = cloud_match(pc_d, pc_h)
            rec.update(unmatched=[u_d, u_h], errs=errs)
            ok = (u_d <= bound_ and u_h <= bound_
                  and max(errs.values()) <= MVS_ATTR_TOL)
        else:
            ok = pc_d is None and pc_h is None
        ok = ok and abs(n_d - n_h) <= bound_ and all(
            abs(v) <= bound_ for v in st_diff.values())
        flips[mode] = rec
        log(f"mvs: {mode} mode on {MVS_CPU_BATCHES} batches, card vs host: "
            f"{n_d} / {n_h} points, stage counts apart by {st_diff}"
            + (f", unmatched {rec['unmatched']}, attributes within "
               + ", ".join(f"{k} {v:.2e}" for k, v in rec["errs"].items())
               if "errs" in rec else "")
            + f" (bounds {bound_} points, attributes {MVS_ATTR_TOL})")
        if not ok:
            fail(f"mvs: generate_point_cloud ({mode}) on the card "
                 f"disagrees with the host")

    # ---- 3. fit() on the gt-mode cloud
    cloud = npts.from_arrays(pc_gt["xyz"], pc_gt["embedding"],
                             pc_gt["conf"], pc_gt["dir"], pc_gt["color"],
                             device=dev)
    params = Aggregator(cfg.agg, seed=0, device=dev)
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.fit(cfg, train_ds, params, cloud, str(root / "run"),
                   max_steps=MVS_FIT_STEPS, print_freq=100, save_freq=0,
                   eval_dataset=test_ds, eval_views=[0, 1],
                   eval_freq=MVS_EVAL_FREQ, seed=0, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fit_launches = dict(_cuda.LAUNCHES)
    curve = [(e["step"], round(e["psnr"], 4)) for e in res.eval_history]
    ips = sorted(r["it_per_sec"] for r in res.log[1:]
                 if "total" in r and r["it_per_sec"] > 0)
    chunks = -(-DATA_HW * DATA_HW // 4096)
    want_sel = MVS_FIT_STEPS + len(curve) * 2 * chunks
    log(f"mvs: fit {MVS_FIT_STEPS} legacy steps on the gt-mode cloud in "
        f"{t_fit:.1f} s, {ips[len(ips) // 2]:.2f} it/s; held-out PSNR by "
        f"step {curve} beside the data phase's depth cloud "
        f"{data['fit']['psnr_curve'][:2]}; launches {fit_launches} "
        f"({want_sel} first_valid_cols expected; {smi})")
    check_launches("mvs fit", fit_launches, {"first_valid_cols": want_sel})
    psnrs = [p for _, p in curve]
    if not (all(np.isfinite(psnrs)) and psnrs[-1] > psnrs[0]):
        fail(f"mvs: the held-out PSNR did not rise ({curve})")

    # ---- 4. the joint step at full width: the chair preset, its 4,096
    # rays a step, JOINT_DEPTH planes, a 100x100 cloud a step, the gate
    # open (dprob_thresh 0.0)
    cfg_j = get_preset("chair")
    R = cfg_j.train.rays_per_batch
    state = tj.create_joint_state(Aggregator(cfg_j.agg, seed=0, device=dev),
                                  cfg_j, num_views=3, seed=0, device=dev)
    r = cfg_j.query.ranges
    rmin, dims = compute_grid_geometry(np.asarray(r[:3]), np.asarray(r[3:]),
                                       cfg_j.query)
    step = tj.make_joint_train_step(cfg_j, rmin, dims,
                                    num_depth=JOINT_DEPTH, dprob_thresh=0.0)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    hw = train_ds.hw

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def make_batch():
        vi = int(rng.integers(len(batches)))
        b = batches[vi]
        xs, ys = rng.integers(0, hw[1], R), rng.integers(0, hw[0], R)
        return tj.MVSTrainBatch(
            images=t(b.images), intrinsics=t(b.intrinsics), w2cs=t(b.w2cs),
            c2ws=t(b.c2ws), near_far=t(b.near_far),
            campos=t(train_ds.campos(vi)),
            camrotc2w=t(train_ds.camrotc2w(vi)),
            raydirs=t(train_ds.raydirs(vi, np.stack([xs, ys], -1))),
            gt_rgb=t(train_ds.images[vi, ys, xs]))

    # on the fresh state, with the gate open: one step's loss and gradients
    # through #1 and through first_valid_cols_reference, from copies of the
    # state and one draw
    b = make_batch()
    noise = torch.randn((hw[0] // 4, hw[1] // 4), generator=gen, device=dev)
    ju = torch.rand((R, cfg_j.query.z_depth_dim), generator=gen, device=dev)
    loss_fn = tj.make_joint_loss_fn(cfg_j, rmin, dims, num_depth=JOINT_DEPTH,
                                    dprob_thresh=0.0)

    def one(plain):
        mvs, fields = copy.deepcopy(state.mvs), copy.deepcopy(state.fields)
        seen = []
        orig = lr.first_valid_cols

        def spy(qs, bp):
            out = orig(qs, bp)
            seen.append((qs.clone(), bp, [o.clone() for o in out]))
            return out

        lr.first_valid_cols = sl.first_valid_cols_reference if plain else spy
        try:
            loss, _ = loss_fn(mvs, fields, b, noise, ju)
            loss.backward()
        finally:
            lr.first_valid_cols = orig
        grads = {n: p.grad for n, p in list(mvs.named_parameters())
                 + [("fields." + n, p) for n, p in fields.named_parameters()]
                 if p.grad is not None}
        return float(loss), grads, seen

    loss_k, g_k, seen = one(False)
    loss_p, g_p, _ = one(True)
    qs, bp, outs = seen[0]
    ref = sl.first_valid_cols_reference(qs, bp)
    same_sel = all(torch.equal(x, y) for x, y in zip(outs, ref))
    g_err = {}
    for grp in ("FeatureNet", "premlp", "costvol.costreg", "costvol.probnet",
                "fields"):
        ks = [n for n in g_k if n.startswith(grp)]
        num = sum(float((g_k[n] - g_p[n]).double().pow(2).sum()) for n in ks)
        den = sum(float(g_p[n].double().pow(2).sum()) for n in ks)
        g_err[grp] = (num ** 0.5) / max(den ** 0.5, 1e-30)
    log(f"mvs: joint step through first_valid_cols against "
        f"first_valid_cols_reference on qs {tuple(qs.shape)}: selection "
        f"{'equal' if same_sel else 'DIFFERS'}, loss {loss_k!r} / "
        f"{loss_p!r}, gradient |diff| / |grad| by group "
        + ", ".join(f"{k} {v:.2e}" for k, v in g_err.items())
        + " (the backward's gathers accumulate with atomics)")
    if not (same_sel and abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
            and max(g_err.values()) <= 1e-4):
        fail("mvs: the joint step through the kernel disagrees with the "
             "plain route")

    # then one step of the run's state split into its parts under the
    # profiler, on the same batch and draws
    held = {}
    state.opt_mvs.zero_grad(set_to_none=True)
    state.opt_fields.zero_grad(set_to_none=True)
    parts = {
        "mvs_forward": lambda: held.update(gen=tj.generate_points_diff(
            state.mvs, b.images, b.intrinsics, b.w2cs, b.c2ws, b.near_far,
            noise=noise, num_depth=JOINT_DEPTH, dprob_thresh=0.0)),
        "render": lambda: held.update(loss=tj.render_generated(
            cfg_j, held["gen"], state.fields, b, rmin, dims, ju)[0]),
        "backward": lambda: held["loss"].backward(),
        "optimizer": lambda: (state.opt_mvs.step(), state.opt_fields.step())}
    split, top = {}, {}
    for name, fn in parts.items():
        rows = sorted(device_rows_once(fn), reverse=True)
        split[name] = sum(x[0] for x in rows)
        top[name] = [(round(ms, 3), n, key[:60]) for ms, n, key in rows[:3]]
    log("mvs: one joint step's device ms by the profiler: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + "; the largest kernels of each part (ms, launches, name): "
        + "; ".join(f"{k}: {v}" for k, v in top.items()))

    before = {n: p.detach().clone() for n, p in state.mvs.named_parameters()}
    f_before = [p.detach().clone() for p in state.fields.parameters()]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.clear()
    losses, valid, windows = [], [], []
    t_joint = time.perf_counter()
    for i in range(JOINT_STEPS):
        if i >= 10 and (i - 10) % 20 == 0 and i + 20 <= JOINT_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        aux = step(state, make_batch(), generator=gen)
        losses.append(aux["total"])
        valid.append(aux["n_valid"])
        if i >= 29 and (i - 29) % 20 == 0:
            torch.cuda.synchronize()
            windows.append(20 / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    t_joint = time.perf_counter() - t_joint
    joint_launches = dict(_cuda.LAUNCHES)
    peak_joint = torch.cuda.max_memory_allocated() - base
    losses = [float(x) for x in losses]
    valid = [int(x) for x in valid]
    moved = {g: max(float((p.detach() - before[n]).abs().max())
                    for n, p in state.mvs.named_parameters()
                    if n.startswith(g))
             for g in ("FeatureNet", "premlp", "costvol.costreg",
                       "costvol.probnet")}
    moved["fields"] = max(float((p.detach() - q).abs().max())
                          for p, q in zip(state.fields.parameters(),
                                          f_before))
    w = sorted(windows)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    n_gen = hw[0] // 4 * (hw[1] // 4)
    # the gate reads prob[bin 2] (ROADMAP section 3): as the ProbNet
    # sharpens, that bin underflows and the gate closes even at 0.0
    log(f"mvs: joint valid points by step (of {n_gen}): "
        + ", ".join(f"{i + 1}: {valid[i]}" for i in
                    [0] + list(range(9, JOINT_STEPS, 10))))
    log(f"mvs: joint {JOINT_STEPS} steps of {R} rays, {JOINT_DEPTH} planes, "
        f"{n_gen} generated points a step ("
        f"{np.mean(valid):.0f} valid on average) in {t_joint:.1f} s: "
        f"{w[len(w) // 2]:.2f} it/s (median of {len(w)} windows of 20 after "
        f"10 warm-up steps; spread {w[0]:.2f}-{w[-1]:.2f}); peak "
        f"{peak_joint} B; loss {first:.5f} (steps 1-10) -> {last:.5f} "
        f"(steps {JOINT_STEPS - 9}-{JOINT_STEPS}); largest change per "
        f"group {moved}; launches {joint_launches} ({smi})")
    check_launches("mvs joint", joint_launches,
                   {"first_valid_cols": JOINT_STEPS})
    if not (np.isfinite(losses).all() and last < first
            and valid[0] >= 0.9 * n_gen):
        fail("mvs: the joint loss did not fall, or the gate was not open "
             "at the first step")
    if min(moved.values()) <= 0:
        fail(f"mvs: a group did not move in the joint steps ({moved})")

    # ---- 5. the command line: MVSNet's gen-points and train-joint
    common = ["--scene", "chair", "--data", str(data_dir)]
    _cuda.LAUNCHES.clear()
    t_cli = time.perf_counter()
    run_cli(["gen-points", *common, "--mvsnet-ckpt", mvs_ckpt, "--fpn-ckpt",
             fpn_ckpt, "--max-batches", "4", "--out", str(root / "gen")],
            "mvs", expect="no point survived")
    text = run_cli(["train-joint", *common, "--steps", "5", "--print-freq",
                    "5", "--out", str(root / "joint_cli")], "mvs",
                   expect="no generated point passes")
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t_cli
    cli_launches = dict(_cuda.LAUNCHES)
    n_gate = int(text.split("step 1: ")[1].split()[0])
    log(f"mvs: the commands took {t_cli:.1f} s; train-joint's gate (0.8) "
        f"passed {n_gate} points at step 1; launches {cli_launches}")
    check_launches("mvs cli", cli_launches, {"first_valid_cols": 5})

    # ---- 6. LPIPS (alex, random weights) of the trained chair's test
    # view 0, the card against the host
    st = res.state
    grid = build_query_grid(st.points.xyz, st.points.alive, cfg.query)
    o = render_image(make_render_chunk_fn(cfg), st.params, st.points, grid,
                     test_ds.campos(0), test_ds.camrotc2w(0),
                     test_ds.full_image_rays(0), test_ds.hw, test_ds.near,
                     test_ds.far, 4096)
    img = np.asarray(o["coarse_raycolor"], np.float32).reshape(
        test_ds.hw + (3,))
    gt = test_ds.images[0]
    v_d = float(lp.lpips_distance(lp.init_random_params("alex", 0, dev),
                                  img, gt))
    v_h = float(lp.lpips_distance(lp.init_random_params("alex", 0, host),
                                  img, gt))
    log(f"mvs: LPIPS (alex, random weights from seed 0: a structure check, "
        f"not a perceptual metric) of test view 0: card {v_d:.6f}, host "
        f"{v_h:.6f}")
    if not (np.isfinite(v_d) and abs(v_d - v_h) <= 1e-4 * abs(v_h)):
        fail("mvs: LPIPS on the card disagrees with the host")
    del grid, st, res, state
    t_total = time.perf_counter() - t_phase
    log(f"mvs phase: {t_total:.1f} s ({smi})")
    return {"depth": depth_rec, "generate": gen_rec, "card_vs_host": flips,
            "fit": {"s": t_fit, "it_per_sec": ips[len(ips) // 2],
                    "psnr_curve": curve},
            "joint": {"it_per_sec": w[len(w) // 2],
                      "it_per_sec_spread": [w[0], w[-1]], "s": t_joint,
                      "peak_bytes": int(peak_joint),
                      "loss_first_last": [first, last],
                      "valid_by_step": valid,
                      "split_ms": split, "split_top": top,
                      "kernel_vs_plain": {
                          "same_selection": same_sel,
                          "loss": [loss_k, loss_p], "grad_rel": g_err}},
            "cli": {"s": t_cli, "train_joint_valid_step1": n_gate},
            "lpips": {"card": v_d, "host": v_h},
            "launches": {"fit": fit_launches, "joint": joint_launches,
                         "cli": cli_launches},
            "s": t_total}


# the multi phase: fit()'s steps under a mesh, the structure sequence's
# probe view (pixels a side), and its worlds (name, ranks, backend): one
# NCCL rank; two and four gloo ranks sharing the card
MULTI_FIT_STEPS, MULTI_PROBE_HW = 100, 200
MULTI_WORLDS = (("a", 1, "nccl"), ("b", 2, "gloo"), ("c", 4, "gloo"))
# seconds a world of ranks may take before its ranks are stopped
MULTI_RANK_TIMEOUT = 300


def _digest(x) -> str:
    import hashlib
    return hashlib.sha1(x.detach().contiguous().cpu().numpy().tobytes()
                        ).hexdigest()


def _multi_step(kind, cfg, d, mesh, params, cloud, grid, geo, st=None):
    """One train step of `kind` ("legacy" on the grid, "fast" on the dense
    geo cache) on the fixed batch and jitter draw: through the sharded
    step where `mesh` is given, else the single-device step. Returns
    (state, aux); the gradients stay on the state's tensors."""
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.parallel import sharding as sh
    from pointnerf2studio_torch.train.trainer import (
        create_train_state, make_train_step)
    if st is None:
        st = create_train_state(params, cloud, cfg)
        if mesh is not None:
            sh.shard_state(st, mesh)
    near, far, u = d["near"], d["far"], d["u"]
    if kind == "legacy":
        fn = (sh.make_sharded_train_step(cfg, mesh) if mesh is not None
              else make_train_step(cfg))
        return fn(st, grid, *d["batch"], near, far, jitter_u=u)
    fn = (sh.make_sharded_fast_train_step(cfg, mesh) if mesh is not None
          else ft.make_fast_train_step(cfg))
    return fn(st, *geo, *d["batch"], near, far, jitter_u=u)


def _step_tensors(st, mesh=None):
    """The gradients, then the updated weights, of the tower and of the
    point attributes (whole: a row-sharded state's gradients
    are put together over "points")."""
    from pointnerf2studio_torch.parallel import sharding as sh
    pts = sh.points_axis(mesh) if mesh is not None else None
    p = list(st.params.parameters())
    a = list(st.points.trainable().values())
    return ([x.grad for x in p] + [sh.gather_blocks(x.grad, pts) for x in a]
            + [x.detach() for x in p]
            + [sh.gather_blocks(x.detach(), pts) for x in a])


def _multi_rank(rank, path, world):
    """One rank of the multi phase (`world` "a": one NCCL rank; "b": two
    gloo ranks, a 1-D mesh; "c": four gloo ranks, a 2x2 mesh), every rank
    on the parent's card. Saves its launches, seconds, peak bytes, digests
    of what it computed and, on rank 0, the arrays the parent checks."""
    import torch
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.ops import _cuda
    from pointnerf2studio_torch.ops.grid import (
        build_grid_from_points, live_bbox)
    from pointnerf2studio_torch.ops.raygen import (
        near_far_linear_ray_generation)
    from pointnerf2studio_torch.parallel import grid_shard as gs
    from pointnerf2studio_torch.parallel import sharding as sh
    from pointnerf2studio_torch.train import loop
    from pointnerf2studio_torch.train.trainer import MOMENTS

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = torch.load(path, weights_only=False)
    dev = next(d["params"].parameters()).device     # the parent's card
    torch.cuda.set_device(dev)
    mesh = {"a": lambda: sh.make_mesh(1, device=dev),
            "b": lambda: sh.make_mesh(2, device=dev),
            "c": lambda: sh.make_mesh_2d(2, 2, device=dev)}[world]()
    pts = sh.points_axis(mesh)
    params, cloud, cfg = d["params"], d["cloud"], d["cfg"]
    grid = build_grid_from_points(cloud.xyz, cloud.alive, cfg.query)
    geo = ft.make_geo_scene(d["cfg_t"], cloud, grid)
    res = {"rank": rank, "launches": {}, "secs": {}, "digest": {},
           "n_occ": int(grid.n_occ), "arrays": {}}
    keep = rank == 0

    def job(name, fn):
        torch.cuda.synchronize()
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["secs"][name] = time.perf_counter() - t0
        res["launches"][name] = dict(_cuda.LAUNCHES)
        return out

    def put(name, tensors):
        res["digest"][name] = [_digest(x) for x in tensors]
        if keep:
            res["arrays"][name] = [x.detach().cpu() for x in tensors]

    def frame(render, cache):
        outs = [render(params, cloud.Rw2c, cache, d["campos"], d["camrot"],
                       d["rays"][i * CHUNK:(i + 1) * CHUNK], d["near"],
                       d["far"], *d["rmin_svs"])
                for i in range(-(-d["rays"].shape[0] // CHUNK))]
        return [torch.cat([getattr(o, f) for o in outs]) for f in
                ("coarse_raycolor", "ray_mask", "acc", "depth")] + [
            torch.stack([getattr(o, f) if getattr(o, f) is not None else
                         torch.zeros((), dtype=torch.int32, device=dev)
                         for o in outs]) for f in
            ("dw_overflow", "rb_overflow", "cb_overflow", "n_valid_slots")]

    for kind in ("legacy", "fast"):
        cf = d["step_cfg"][kind]
        st, aux = job(f"step_{kind}", lambda: _multi_step(
            kind, cf, d, mesh, params, cloud, grid, geo))
        res[f"loss_{kind}"] = float(aux["total"])
        res[f"rows_{kind}"] = [int(x.shape[0]) for x in
                               st.points.trainable().values()]
        res[f"moment_rows_{kind}"] = [
            int(st.opt_points.state[x][k].shape[0])
            for x in st.points.trainable().values() for k in MOMENTS]
        put(f"step_{kind}", _step_tensors(st, mesh))
        del st

    if world == "a":
        render = sh.make_sharded_fast_render(cfg, mesh)
        out = job("chunk0", lambda: render(
            params, cloud.Rw2c, fr.make_fast_scene(cfg, cloud, grid)[0],
            d["campos"], d["camrot"], d["rays"][:CHUNK], d["near"],
            d["far"], *d["rmin_svs"]))
        put("chunk0", [out.coarse_raycolor, out.ray_mask, out.acc])
    elif world == "b":
        cache = fr.make_fast_scene(cfg, cloud, grid)[0]
        render = sh.make_sharded_fast_render(cfg, mesh)
        put("frame", job("frame", lambda: frame(render, cache)))
        del cache
        legacy = sh.make_sharded_render(d["cfg_b0"], mesh)
        out = job("legacy_chunk", lambda: legacy(
            params, cloud, grid, d["campos"], d["camrot"],
            d["rays"][:CHUNK], d["near"], d["far"]))
        put("legacy_chunk", [out.coarse_raycolor, out.ray_mask, out.acc])
        del out
        out_dir = d["fit_dir"]
        fit = job("fit", lambda: loop.fit(
            d["cfg_fit"], d["ds"], params, cloud, out_dir,
            max_steps=MULTI_FIT_STEPS, print_freq=10, seed=3, mesh=mesh,
            resume=False))
        res["fit_log"] = [r["total"] for r in fit.log]
        put("fit_state", list(fit.state.params.parameters())
            + list(fit.state.points.trainable().values()))
        del fit
    else:
        cache = fr.make_fast_scene(d["cfg_x"], cloud, grid)[0]
        whole_bytes = nbytes(cache.kmeta, cache.kcand, cache.kxyz)
        cache = sh.shard_fat_cache(cache, mesh)
        torch.cuda.empty_cache()
        res["cache_bytes"] = (nbytes(cache.kmeta, cache.kcand, cache.kxyz),
                              whole_bytes)
        render = sh.make_sharded_fast_render_pt(d["cfg_x"], mesh)
        put("xla_frame", job("xla_frame", lambda: frame(render, cache)))
        del cache
        # the slab query on chunk 0's rays over the "points" axis
        q = cfg.query
        raypos = near_far_linear_ray_generation(
            d["campos"], d["rays"][:CHUNK], q.z_depth_dim, d["near"],
            d["far"])[0]
        rmin, dims, slab_w, halo = gs.slab_geometry(
            q, *live_bbox(cloud.xyz, cloud.alive), 2)
        query = gs.make_sharded_query(q, mesh, rmin, dims, slab_w, halo,
                                      max_o_local=q.max_o)
        qo = job("slab_query", lambda: query(cloud.xyz, cloud.alive,
                                             raypos))
        res["slab"] = (int(dims[0]), slab_w, halo)
        put("slab_query", [torch.sort(qo[0], -1).values, *qo[1:]])
        del raypos, qo
        # the structure sequence of the reference's dry run, then a step
        res["structure"] = job("structure", lambda: _multi_structure(
            d, mesh, params, cloud, grid))
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["secs"]["rank"] = time.perf_counter() - t_start
    torch.save(res, f"{path}.{world}.{rank}")


def _multi_structure(d, mesh, params, cloud, grid):
    """Capacity expansion to a capacity the "points" axis divides, probe
    and grow on one view, prune, each with the state whole for the event
    and re-sharded after it, then a sharded step."""
    import torch
    from pointnerf2studio_torch.data.blender import BlenderDataset
    from pointnerf2studio_torch.models import neural_points as npm
    from pointnerf2studio_torch.ops.grid import build_grid_from_points
    from pointnerf2studio_torch.parallel import sharding as sh
    from pointnerf2studio_torch.train.grow import probe_and_grow
    from pointnerf2studio_torch.train.trainer import (
        MOMENTS, expand_state_capacity)
    cfg = d["cfg_l"]
    st, _ = _multi_step("legacy", cfg, d, mesh, params, cloud, grid, None)
    cap0 = st.points.capacity
    with sh.whole_state(st, mesh):
        expand_state_capacity(st, cap0 + 4097)
    hw = MULTI_PROBE_HW
    pose = orbit_pose(30.0)
    ds = BlenderDataset(
        images=np.broadcast_to(np.asarray(TRAIN_COLOUR, np.float32),
                               (1, hw, hw, 3)).copy(),
        poses=pose[None], intrinsics=np.array(
            [[FOCAL * hw / W, 0, hw / 2], [0, FOCAL * hw / W, hw / 2],
             [0, 0, 1]], np.float32),
        near=d["near"], far=d["far"], split="train")
    with sh.whole_state(st, mesh):
        st, grid, n_new = probe_and_grow(cfg, st, grid, ds, views=[0],
                                         chunk=CHUNK, opacity_thresh=0.05,
                                         probe="legacy")
    n_grown = int(st.points.num_alive)
    with sh.whole_state(st, mesh), torch.no_grad():
        st.points.points_conf[:64] = 0.01
        st.points = npm.prune(st.points, 0.1)
    grid = build_grid_from_points(st.points.xyz, st.points.alive, cfg.query)
    st, aux = _multi_step("legacy", cfg, d, mesh, params, cloud, grid, None,
                          st=st)
    out = dict(cap0=cap0, cap=st.points.capacity, n_new=int(n_new),
               n_grown_alive=n_grown, n_alive=int(st.points.num_alive),
               local_rows=int(st.points.points_embeding.shape[0]),
               moment_rows=[int(st.opt_points.state[x][k].shape[0])
                            for x in st.points.trainable().values()
                            for k in MOMENTS],
               loss=float(aux["total"]))
    sh.unshard_state(st, mesh)
    out["digest"] = [_digest(x) for x in _step_tensors(st)[-4:]]
    return out


def multi_phase(c) -> dict:
    """Multi-device execution (parallel/sharding.py) on the one card: (a)
    one NCCL rank, (b) two gloo ranks on cuda:0 as a 1-D mesh, (c) four
    as a 2x2 mesh, each rank in a process of its own loading the chair
    scene and weights the parent saves, held to the parent's single-device
    results; (d) `cli train --num-devices 2` refused on one card. The
    sharded steps' it/s is gloo on one card, not a multi-GPU rate."""
    import tempfile

    import torch
    from pointnerf2studio_torch import cli
    from pointnerf2studio_torch.models import fast_render as fr
    from pointnerf2studio_torch.models import fast_train as ft
    from pointnerf2studio_torch.models import render as lr
    from pointnerf2studio_torch.ops.query import query_grid_point_index
    from pointnerf2studio_torch.ops.raygen import (
        near_far_linear_ray_generation)
    from pointnerf2studio_torch.parallel import sharding as sh

    t_phase = time.perf_counter()
    scene, dev, grid = c.scene, c.dev, c.scene.grid
    ts = c.train_setup
    q = c.cfg.query
    cfg_t = ts["cfg"]
    cfg_l = dataclasses.replace(cfg_t, train=dataclasses.replace(
        cfg_t.train, fast_path=False))
    cfg_b0 = dataclasses.replace(
        c.cfg, query=dataclasses.replace(q, compact_budget=0),
        agg=dataclasses.replace(c.cfg.agg, fused_decode=True))
    cfg_x = dataclasses.replace(
        c.cfg, query=dataclasses.replace(q, chunk_mode="xla",
                                         knn_mode="xla",
                                         fast_chunk=ROUTE_XLA_CHUNK),
        agg=dataclasses.replace(c.cfg.agg, fused_decode2=True))
    cfg_fit = dataclasses.replace(cfg_l, train=dataclasses.replace(
        cfg_l.train, device_sampling=False))
    # the steps held to the single-device step run at float32: at bfloat16
    # each rank's weight gradients come out of bf16 matmuls, rounded to
    # bf16 before the sum over ranks, a relative 2^-8 from the single
    # step's rounding of the whole sum
    step_cfg = {k: dataclasses.replace(cf, agg=dataclasses.replace(
        cf.agg, compute_dtype="float32"))
        for k, cf in (("legacy", cfg_l), ("fast", cfg_t))}
    tmp = pathlib.Path(tempfile.mkdtemp(dir="build"))
    d = dict(
        cfg=c.cfg, cfg_t=cfg_t, cfg_l=cfg_l, cfg_b0=cfg_b0, cfg_x=cfg_x,
        cfg_fit=cfg_fit, step_cfg=step_cfg, params=scene.params,
        cloud=scene.cloud,
        campos=scene.campos, camrot=scene.camrotc2w, rays=c.raydirs,
        near=scene.near, far=scene.far, rmin_svs=(c.rmin, c.svs),
        batch=ts["batch"][:4], u=ts["u"], ds=ts["ds"],
        fit_dir=str(tmp / "fit"))
    path = str(tmp / "inputs.pt")
    torch.save(d, path)
    log(f"multi: the chair scene, weights, frame rays and train batch saved "
        f"for the ranks ({os.path.getsize(path)} B)")

    # ---- the parent's single-device results, on the weights as they are
    # now (the frame of path 1 rendered again)
    single = {}
    geo = ft.make_geo_scene(cfg_t, scene.cloud, grid)
    for kind in ("legacy", "fast"):
        st, aux = _multi_step(kind, step_cfg[kind], d, None, scene.params,
                              scene.cloud, grid, geo)
        single[kind] = (float(aux["total"]), _step_tensors(st))
        del st
    with torch.no_grad():
        out = lr.render_rays(scene.params, scene.cloud, grid, scene.campos,
                             scene.camrotc2w, c.raydirs[:CHUNK], scene.near,
                             scene.far, cfg_b0)
    single["legacy_chunk"] = [out.coarse_raycolor, out.ray_mask, out.acc]
    del out
    cache_x = fr.make_fast_scene(cfg_x, scene.cloud, grid)[0]
    outs_x = [fr.fast_render_rays(
        scene.params, scene.cloud.Rw2c, cache_x, scene.campos,
        scene.camrotc2w, c.raydirs[i * CHUNK:(i + 1) * CHUNK], scene.near,
        scene.far, cfg_x, c.rmin, c.svs) for i in range(c.n_chunks)]
    del cache_x

    def frame_of(outs):
        return [torch.cat([getattr(o, f) for o in outs]) for f in
                ("coarse_raycolor", "ray_mask", "acc", "depth")]

    cache = fr.make_fast_scene(c.cfg, scene.cloud, grid)[0]
    outs = [fr.fast_render_rays(
        scene.params, scene.cloud.Rw2c, cache, scene.campos,
        scene.camrotc2w, c.raydirs[i * CHUNK:(i + 1) * CHUNK], scene.near,
        scene.far, c.cfg, c.rmin, c.svs) for i in range(c.n_chunks)]
    del cache
    single["frame"] = frame_of(outs)
    single["frame_counters"] = {
        f: sum(int(getattr(o, f)) for o in outs
               if getattr(o, f) is not None)
        for f in ("dw_overflow", "rb_overflow", "cb_overflow",
                  "n_valid_slots")}
    single["xla_frame"] = frame_of(outs_x)
    single["chunk0"] = [outs[0].coarse_raycolor, outs[0].ray_mask,
                        outs[0].acc]
    del outs_x, outs
    raypos = near_far_linear_ray_generation(
        scene.campos, c.raydirs[:CHUNK], q.z_depth_dim, scene.near,
        scene.far)[0]
    r = query_grid_point_index(grid, scene.cloud.xyz, raypos, q.SR, q.K,
                               q.radius_limit ** 2, q.kernel_size,
                               layered=q.layered_search)
    single["slab_query"] = [torch.sort(r.sample_pidx, -1).values,
                            r.sample_loc_w, r.sample_mask, r.ray_mask]
    del raypos, r
    torch.cuda.synchronize()
    log(f"multi: single-device results in "
        f"{time.perf_counter() - t_phase:.1f} s")

    def equal(name, got, want):
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not torch.equal(a.to(b.device), b)]
        if bad or len(got) != len(want):
            fail(f"multi {name}: tensors {bad} of {len(want)} differ")

    def near_step(name, loss, got, want):
        loss1, ten = want
        n = len(ten) // 2
        if abs(loss - loss1) > 1e-6 * abs(loss1):
            fail(f"multi {name}: loss {loss!r} against {loss1!r}")
        worst = max(float((a.to(b.device) - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(got[:n], ten[:n]))
        if worst > 1e-5:
            fail(f"multi {name}: a gradient {worst:.3e} of its max apart")
        return worst

    torch.cuda.empty_cache()        # the ranks share the card
    runs = {}
    for world, n, backend in MULTI_WORLDS:
        t0 = time.perf_counter()
        try:
            sh.run_ranks(_multi_rank, n, backend, (path, world),
                         timeout=MULTI_RANK_TIMEOUT)
        except Exception as e:      # a rank failed: its error is above
            fail(f"multi ({world}): a rank failed: {e}")
        ranks = [torch.load(f"{path}.{world}.{k}", weights_only=False)
                 for k in range(n)]
        runs[world] = ranks
        for rk in ranks[1:]:
            if rk["digest"] != ranks[0]["digest"]:
                fail(f"multi ({world}): rank {rk['rank']} computed other "
                     f"results than rank 0")
            if rk["n_occ"] != int(grid.n_occ):
                fail(f"multi ({world}): the rank's grid differs")
        for rk in ranks:
            log(f"multi ({world}, {backend}) rank {rk['rank']}: launches "
                f"{rk['launches']}, peak {rk['peak_bytes']} B, seconds "
                f"{ {k: round(v, 2) for k, v in rk['secs'].items()} }")
        log(f"multi ({world}): {n} rank(s) over {backend} in "
            f"{time.perf_counter() - t0:.1f} s")
    # each kernel of a job's path launched on every rank
    want = {"a": {"step_legacy": ["first_valid_cols"],
                  "step_fast": ["first_valid_cols"],
                  "chunk0": ["first_valid_cols", "fused_chunk_decode"]},
            "b": {"frame": ["first_valid_cols", "fused_chunk_decode"],
                  "legacy_chunk": ["first_valid_cols", "fused_decode"],
                  "step_legacy": ["first_valid_cols"],
                  "step_fast": ["first_valid_cols"],
                  "fit": ["first_valid_cols"]},
            "c": {"step_legacy": ["first_valid_cols"],
                  "xla_frame": ["first_valid_cols", "fused_decode2"],
                  "structure": ["first_valid_cols"]}}
    for world, jobs in want.items():
        for rk in runs[world]:
            for job, names in jobs.items():
                for name in names:
                    if rk["launches"][job].get(name, 0) < 1:
                        fail(f"multi ({world}) rank {rk['rank']}: {name} "
                             f"not launched on {job}")
    out = {}

    # ---- (a) one NCCL rank: the sharded steps are the unsharded ones
    a = runs["a"][0]
    for kind in ("legacy", "fast"):
        if a[f"loss_{kind}"] != single[kind][0]:
            fail(f"multi (a): sharded {kind} step's loss differs")
        equal(f"(a) {kind} step", a["arrays"][f"step_{kind}"],
              single[kind][1])
    equal("(a) chunk 0", a["arrays"]["chunk0"], single["chunk0"])
    log("multi (a): NCCL world of 1: sharded legacy and fast dense steps "
        "bit-equal to the unsharded steps (loss, gradients, updated "
        "weights); make_sharded_fast_render's chunk 0 bit-equal to the "
        "direct call's")

    # ---- (b) two gloo ranks on cuda:0
    b = runs["b"][0]
    fb = b["arrays"]["frame"]
    equal("(b) fused-chunk frame", fb[:4], single["frame"])
    sums = {f: int(x.sum()) for f, x in zip(
        ("dw_overflow", "rb_overflow", "cb_overflow", "n_valid_slots"),
        fb[4:])}
    if any(sums[f] for f in ("dw_overflow", "rb_overflow", "cb_overflow")) \
            or sums != single["frame_counters"]:
        fail(f"multi (b): counters {sums} against "
             f"{single['frame_counters']}")
    equal("(b) legacy chunk", b["arrays"]["legacy_chunk"],
          single["legacy_chunk"])
    worst_b = {k: near_step(f"(b) {k} step", b[f"loss_{k}"],
                            b["arrays"][f"step_{k}"], single[k])
               for k in ("legacy", "fast")}
    fl = b["fit_log"]
    if not (len(fl) == MULTI_FIT_STEPS // 10 and fl[-1] <= fl[0] / 4):
        fail(f"multi (b): fit(mesh=) loss {fl}")
    ips_b = MULTI_FIT_STEPS / b["secs"]["fit"]
    log(f"multi (b): 2 gloo ranks on {dev}: the {H}x{W} fused-chunk frame "
        f"bit-equal, counters summed {sums}; the {CHUNK}-ray legacy chunk "
        f"at compact budget 0 (fused_decode) bit-equal; sharded steps "
        f"against the single step: gradients within {worst_b} of their max; "
        f"fit(mesh=) {MULTI_FIT_STEPS} legacy steps, loss {fl[0]:.6f} -> "
        f"{fl[-1]:.6f} ({fl[0] / fl[-1]:.1f}x), both ranks' states equal; "
        f"{ips_b:.2f} it/s of {TRAIN_RAYS}-ray steps (gloo on one card: no "
        f"multi-GPU rate; fit's set-up included; {c.smi})")

    # ---- (c) four gloo ranks on cuda:0 as a 2x2 mesh
    cc_ = runs["c"][0]
    worst_c = near_step("(c) point-sharded legacy step", cc_["loss_legacy"],
                        cc_["arrays"]["step_legacy"], single["legacy"])
    cap = scene.cloud.capacity
    for rk in runs["c"]:
        half = -(-cap // 2)
        if (rk["rows_legacy"] != [half] * 4
                or rk["moment_rows_legacy"] != [half] * 8):
            fail(f"multi (c): rank {rk['rank']} holds rows "
                 f"{rk['rows_legacy']}, moments {rk['moment_rows_legacy']}")
    equal("(c) point-sharded XLA frame", cc_["arrays"]["xla_frame"][:4],
          single["xla_frame"])
    if any(int(x.sum()) for x in cc_["arrays"]["xla_frame"][4:7]):
        fail("multi (c): a counter of the point-sharded frame is non-zero")
    equal("(c) slab query", cc_["arrays"]["slab_query"],
          single["slab_query"])
    s_ = cc_["structure"]
    digests = {tuple(rk["structure"]["digest"]) for rk in runs["c"]}
    if (len(digests) != 1 or s_["cap"] % 2 or s_["cap"] <= s_["cap0"]
            or s_["local_rows"] != s_["cap"] // 2
            or s_["moment_rows"] != [s_["cap"] // 2] * 8
            or not np.isfinite(s_["loss"])):
        fail(f"multi (c): structure sequence {s_}")
    log(f"multi (c): 2x2 gloo ranks on {dev}: point-sharded legacy step "
        f"within {worst_c:.3e} of the single step, each rank holding "
        f"{half} of {cap} attribute rows and their moments; the point-"
        f"sharded XLA frame (fused_decode2) bit-equal to the unsharded "
        f"one, each rank's cache {cc_['cache_bytes'][0]} B of "
        f"{cc_['cache_bytes'][1]} B; the slab query over 2 slabs "
        f"{cc_['slab']} equal to the unsharded query on chunk 0's rays; "
        f"structure: capacity {s_['cap0']} -> {s_['cap']}, grown "
        f"{s_['n_new']}, alive {s_['n_grown_alive']} -> {s_['n_alive']} "
        f"after the prune, then a step (loss {s_['loss']:.6f}); every "
        f"rank's state equal")

    # ---- (d) the CLI on one card
    try:
        cli.main(["train", "--data", str(tmp), "--point-cloud", str(tmp),
                  "--out", str(tmp), "--num-devices", "2"])
    except ValueError as e:
        if f"need 2 devices, have {torch.cuda.device_count()}" not in str(e):
            fail(f"multi (d): cli refused with {e}")
        log(f"multi (d): cli train --num-devices 2 on one card: {e}")
    else:
        fail("multi (d): cli train --num-devices 2 ran on one card")
    shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"multi: phase {secs:.1f} s")
    for world, ranks in runs.items():
        out[world] = [{"launches": rk["launches"], "peak_bytes":
                       rk["peak_bytes"], "secs": rk["secs"]}
                      for rk in ranks]
    out.update(secs=secs, fit_it_per_s_gloo_one_card=ips_b,
               grad_rel={"b": worst_b, "c": worst_c},
               cache_bytes_2x2=cc_["cache_bytes"],
               structure={k: v for k, v in s_.items() if k != "digest"},
               fit_loss=fl)
    return out


def steps_in_turns(runs: dict, go, smi: str) -> dict:
    """Train it/s of each run (`go(run, n)` takes n steps): 10 warm-up
    steps each, then 3 windows of 20 steps, the runs in turns; the median
    window and the spread, by the host clock to a synchronise."""
    import torch
    for r in runs.values():
        go(r, 10)
    for _ in range(3):
        for r in runs.values():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go(r, 20)
            torch.cuda.synchronize()
            r["ips"].append(20 / (time.perf_counter() - t0))
    ips = {}
    for name, r in runs.items():
        v = sorted(r["ips"])
        ips[name] = {"median": v[1], "min": v[0], "max": v[2]}
        log(f"train {name}: {v[1]:.2f} it/s of {TRAIN_RAYS}-ray steps "
            f"(median of 3 windows of 20 after 10 warm-up steps; spread "
            f"{v[0]:.2f}-{v[2]:.2f}; in turns; {smi})")
    return ips


def step_profile(name: str, fwd, update, out_dir=None) -> dict:
    """A train step split into its forward (`fwd()`: zero the gradients,
    render, return the loss), its backward and its optimizer update
    (`update()`), each under its own profiler pass, beside the unprofiled
    step's time: device ms of each part, launches, idle share, and the
    kernel names seen; the table goes to `out_dir/profile_<name>.txt`."""
    def step():
        fwd().backward()
        update()

    step_ms = cuda_ms(step, 3, 1)
    rows = {}
    for part in ("forward", "backward", "optimizer"):
        if part == "forward":
            rows[part] = device_rows_once(fwd)
            continue
        loss = fwd()
        if part == "backward":
            rows[part] = device_rows_once(loss.backward)
        else:
            loss.backward()
            rows[part] = device_rows_once(update)
    tot = {p: sum(x[0] for x in v) for p, v in rows.items()}
    merged = {}
    for v in rows.values():
        for ms, n, key in v:
            a = merged.setdefault(key, [0.0, 0])
            a[0] += ms
            a[1] += n
    top = sorted(((ms, n, k) for k, (ms, n) in merged.items()), reverse=True)
    dev_ms = sum(tot.values())
    out = {"step_ms": step_ms, **{f"{p}_ms": t for p, t in tot.items()},
           "idle": 1 - dev_ms / step_ms, "launches": sum(x[1] for x in top),
           "names": sorted(merged)}
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"profile_{name.replace(' ', '_')}.txt").write_text(
            "".join(f"{ms:10.3f} ms {n:6d} x {key}\n" for ms, n, key in top))
    log(f"profile {name}: step {step_ms:.2f} ms; device forward "
        f"{tot['forward']:.2f}, backward {tot['backward']:.2f}, optimizer "
        f"{tot['optimizer']:.2f} ms ({dev_ms:.2f} in {out['launches']} "
        f"launches); idle share {out['idle']:.3f}")
    for ms, n, key in top[:10]:
        log(f"  {ms:9.3f} ms {100 * ms / dev_ms:5.1f}% {n:5d} x {key[:90]}")
    return out


def device_rows_once(fn):
    """[(device ms, launches, kernel name)] of one call of `fn` under
    torch.profiler (no warm-up call: `fn` may change state)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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
        f"{cache.max_q}, C {cache.cand}; depth_window {dw}, "
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
        + ", ".join(f"{n} {ms_text(t_fc_parts[n])}" for n in fc_parts)
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
        with torch.no_grad():
            return lr.render_rays(scene.params, scene.cloud, grid,
                                  scene.campos, scene.camrotc2w, rays0,
                                  scene.near, scene.far, cfg_b)

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

    # =================================================================
    # The reference's default front-ends: march, raster, render_frame
    # =================================================================
    import types
    ns = types.SimpleNamespace(
        scene=scene, cache=cache, cfg=cfg, dev=dev, rmin=rmin, svs=svs,
        raydirs=raydirs, raydirs_frame=raydirs_frame, perm=perm, outs=outs,
        n_chunks=n_chunks, total=total, smi=smi, prof_dir=prof_dir,
        outs_a=outs_a)
    fe = front_end_phases(ns)

    # =================================================================
    # The frame check that depends on the payload, and the train path
    # =================================================================
    payload = payload_phase(ns)
    train = train_phases(ns)

    # =================================================================
    # The reference's opt-in render and train routes on chair-800p and
    # chair-train
    # =================================================================
    routes = routes_phase(ns)

    # =================================================================
    # The render probes of the XLA route, stage by stage, on chair-800p
    # =================================================================
    probes = probes_phase(ns)

    # =================================================================
    # The reference's default route: the candidate cache, the legacy step
    # =================================================================
    legacy = legacy_phases(ns)

    # =================================================================
    # Growth, pruning, evaluation and checkpoints: fit() as the chair
    # preset runs it
    # =================================================================
    structure = structure_phase(ns)

    # =================================================================
    # The plane background on the chair, and the large-scene route on the
    # ScanNet-scale room
    # =================================================================
    plane = plane_phase(ns)
    room = large_scene_phase(ns)

    # =================================================================
    # The user's data path and entry point: the procedural chair on disk,
    # the depth initialisation, fit() to a held-out PSNR, the command line
    # =================================================================
    data = data_phase(ns)

    # =================================================================
    # MVSNet point generation and joint MVS training on the chair-data
    # dataset
    # =================================================================
    mvs = mvs_phase(ns, data)

    # =================================================================
    # Multi-device execution: one NCCL rank, two and four gloo ranks
    # sharing the card
    # =================================================================
    multi = multi_phase(ns)

    # =================================================================
    # The generic kernels: the widths the tuned kernels are not built
    # for, on chair-800p at full size and depth
    # =================================================================
    widths = widths_phase(ns)

    def multi_launches(kernel):
        """The kernel's launches per job on every rank of the multi
        phase's worlds."""
        return {w: [{j: v.get(kernel, 0) for j, v in rk["launches"].items()
                     if v.get(kernel, 0)} for rk in ranks]
                for w, ranks in multi.items() if w in ("a", "b", "c")}

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
            f"measured {ms_text(t_sel)} ms with its {out_b / 1e6:.1f} MB of "
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

    def any_record(name, source, replaces):
        """A generic kernel's record: its launches, error and times on its
        wide path's chunk 0; its narrow runs beside them."""
        r = widths["kernels"][name]
        narrow = {k: v for k, v in widths["narrow"].items()
                  if k.startswith(name.replace("_any", "") + "_any")}
        return record(name, source, replaces, r["launches"],
                      r["max_abs_err"], r["ms"], r["plain_ms"],
                      (r["bound_ms"], r["bound_by"]),
                      extra={"widths": "wide", "M": r["M"],
                             "narrow": narrow})

    def by_route(kernel):
        """The kernel's launches on each route of the routes phase."""
        return {k: v[kernel] for k, v in routes["launches"].items()
                if v.get(kernel, 0)}

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
                                 "bound_ms": b_selb[0]},
                             "train": train["select"],
                             "legacy_train": legacy["select"],
                             "structure": {
                                 "fit": structure["fit_launches"].get(
                                     "first_valid_cols", 0),
                                 "per_probe": [
                                     p.get("first_valid_cols", 0) for p in
                                     structure["fit_probe_launches"]],
                                 "per_eval_view": structure["eval_launches"][
                                     "legacy"].get("first_valid_cols", 0)},
                             "large_scene": room["select"],
                             "data": {
                                 k: v.get("first_valid_cols", 0)
                                 for k, v in data["launches"].items()},
                             "mvs": {
                                 k: v.get("first_valid_cols", 0)
                                 for k, v in mvs["launches"].items()},
                             "routes": by_route("first_valid_cols"),
                             "probes": probes["launches"]["first_valid_cols"],
                             "multi": multi_launches("first_valid_cols")}),
        record("fused_candidate_select", "fused_select.cu",
               "fused_select.py:60", launches_a["fused_candidate_select"],
               fsel_err, t_fs_k, t_fs_p, b_fs,
               extra={"routes": by_route("fused_candidate_select")}),
        record("fused_decode", "fused_decode.cu", "fused_decode.py:91",
               launches_b["fused_decode"], pair_err, t_pt_k, t_pt_p, b_pt,
               f_pt, extra={"cache_route": legacy["decode"],
                            "structure": {
                                "per_eval_view": structure["eval_launches"][
                                    "legacy"].get("fused_decode", 0),
                                "fit": structure["fit_launches"].get(
                                    "fused_decode", 0)},
                            "plane_legacy_fit": plane["fit"]["legacy"][
                                "launches"].get("fused_decode", 0),
                            "data": {
                                k: v.get("fused_decode", 0)
                                for k, v in data["launches"].items()},
                            "mvs": {
                                k: v.get("fused_decode", 0)
                                for k, v in mvs["launches"].items()},
                            "multi": multi_launches("fused_decode")}),
        record("fused_decode2", "fused_decode.cu", "fused_decode.py:235",
               launches_a["fused_decode2"], kacc_err, t_ka_k, t_ka_p, b_ka,
               f_ka, extra={"large_scene": room["kacc"],
                            "routes": by_route("fused_decode2"),
                            "probes": probes["launches"]["fused_decode2"],
                            "multi": multi_launches("fused_decode2")}),
        record("fused_chunk_decode", "fused_chunk.cu", "fused_chunk.py:86",
               launches["fused_chunk_decode"], fused_err, t_fc_k, t_fc_p,
               b_fc, f_fc, t_fc_parts, extra={"structure": {
                   "per_eval_view": structure["eval_launches"]["fast"].get(
                       "fused_chunk_decode", 0)},
                   "large_scene_ground_truth": room["chunk_gt"],
                   "plane": {k: v.get("fused_chunk_decode", 0)
                             for k, v in plane["launches"].items()},
                   "data": {k: v.get("fused_chunk_decode", 0)
                            for k, v in data["launches"].items()},
                   "routes": by_route("fused_chunk_decode"),
                   "multi": multi_launches("fused_chunk_decode")}),
        record("march_rays", "march.cu", "march.py:70", **{
            **fe["record"], "extra": {**fe["record"]["extra"],
                                      "train": train["march"]}}),
    ] + [any_record(*r) for r in (
        ("fused_candidate_select_any", "fused_select.cu",
         "fused_select.py:60"),
        ("fused_decode_any", "decode_any.cu", "fused_decode.py:91"),
        ("fused_decode2_any", "decode_any.cu", "fused_decode.py:235"),
        ("fused_chunk_decode_any", "chunk_any.cu", "fused_chunk.py:86"))],
        "launches_by_path": {"fused_chunk": launches, "staged": launches_a,
                            "legacy": launches_b, **fe["launches"],
                            **legacy["launches"], **routes["launches"]},
        "routes": routes["stats"],
        "probes": {k: v for k, v in probes.items() if k != "launches"},
        "front_end_frame_ms": fe["frame_ms"],
        "raster_emit_program_ms": fe["emit_program_ms"],
        "raster_emit_ms": fe["emit_ms"], "march_plan": fe["march_plan"],
        "payload_check": payload,
        "train": {k: v for k, v in train.items()
                  if k not in ("select", "march")},
        "legacy": {k: v for k, v in legacy.items()
                   if k not in ("select", "decode", "launches")},
        "structure": structure,
        "plane": {k: v for k, v in plane.items() if k != "launches"},
        "large_scene": {k: v for k, v in room.items()
                        if k not in ("select", "kacc", "chunk_gt")},
        "data": {k: v for k, v in data.items() if k != "launches"},
        "mvs": {k: v for k, v in mvs.items() if k != "launches"},
        "multi": multi,
        "widths": {k: v for k, v in widths.items() if k != "kernels"}}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
