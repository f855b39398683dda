"""Per-scene configuration presets.

A copy of the jax-free `pointnerf2studio_tpu/data/presets.py` on the
port's config classes. The reference configures scenes through 22
~180-line bash scripts
(reference: pointnerf/dev_scripts/{w_n360,w_colmap_n360,w_scannet_etf,
w_tt_ft}/*.sh). Here each preset is a PointNerfConfig diff. Canonical
hyperparameters:
  * NeRF-Synthetic (w_n360/chair_points.sh:50-61): vsize 0.004,
    vscale 2, SR 80, K 8, P 12, max_o 410k, vox_res 320, D 400
  * ScanNet (w_scannet_etf/scene241_points.sh): vsize 0.008, SR 24,
    max_o 610k, vox_res 900
  * Tanks&Temples (w_tt_ft/truck-style): vsize 0.002, SR 40,
    max_o 1.6M, vox_res 640
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from pointnerf2studio_torch.config import (
    AggregatorConfig, PointNerfConfig, QueryConfig, TrainConfig)

NERF_SYNTH_SCENES = ("chair", "drums", "ficus", "hotdog", "lego",
                     "materials", "mic", "ship")
SCANNET_SCENES = ("scene0101_04", "scene0241_01")
TT_SCENES = ("Barn", "Caterpillar", "Family", "Ignatius", "Truck")
COLMAP_SCENES = tuple("col_" + s for s in NERF_SYNTH_SCENES)

# COLMAP-reconstruction crop ranges differ slightly from the GT-camera
# ones (dev_scripts/w_colmap_n360/col_*_points.sh:53).
COLMAP_RANGES: Dict[str, tuple] = {
    "col_chair": (-0.721, -0.695, -0.995, 0.658, 0.706, 1.050),
    "col_drums": (-1.126, -0.746, -0.492, 1.122, 0.962, 0.939),
    "col_ficus": (-0.377, -0.858, -1.034, 0.555, 0.578, 1.141),
    "col_hotdog": (-1.198, -1.286, -0.190, 1.198, 1.110, 0.312),
    "col_lego": (-0.638, -1.141, -0.346, 0.634, 1.149, 1.141),
    "col_materials": (-1.123, -0.759, -0.232, 1.072, 0.986, 0.200),
    "col_mic": (-1.252, -0.910, -0.742, 0.767, 1.082, 1.151),
    "col_ship": (-1.277, -1.300, -0.550, 1.371, 1.349, 0.729),
}

# Per-scene world-space crop ranges (dev_scripts/w_n360/*_points.sh).
NERF_SYNTH_RANGES: Dict[str, tuple] = {
    "chair": (-0.721, -0.695, -0.995, 0.658, 0.706, 1.050),
    "drums": (-1.144, -0.740, -0.520, 1.150, 0.945, 0.821),
    "ficus": (-0.503, -0.786, -1.082, 0.576, 0.739, 1.136),
    "hotdog": (-1.323, -1.246, -0.220, 1.380, 1.253, 0.481),
    "lego": (-0.672, -1.186, -0.507, 0.658, 1.200, 1.090),
    "materials": (-1.191, -0.788, -0.360, 1.120, 1.072, 0.350),
    "mic": (-1.318, -0.963, -0.775, 0.916, 1.233, 1.094),
    "ship": (-1.362, -1.346, -0.708, 1.348, 1.384, 0.728),
}


def nerf_synth_config(scene: str = "chair", **overrides) -> PointNerfConfig:
    ranges = NERF_SYNTH_RANGES.get(scene, (-1.2,) * 3 + (1.2,) * 3)
    query = QueryConfig(
        vsize=(0.004, 0.004, 0.004), vscale=(2, 2, 2),
        kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        ranges=ranges, z_depth_dim=400, SR=80, K=8,
        max_o=410_000, P=12)
    cfg = PointNerfConfig(
        query=query,
        agg=AggregatorConfig(),
        # chair_points.sh: prune_thresh 0.1, prob 10001/0.7/x0.4
        train=TrainConfig(max_iterations=200_000, rays_per_batch=4096,
                          prune_thresh=0.1, prob_freq=10_001,
                          prob_thresh=0.7, prob_mul=0.4),
        near_plane=2.0, far_plane=6.0,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def colmap_config(scene: str = "col_chair", **overrides) -> PointNerfConfig:
    """COLMAP-initialized NeRF-Synthetic family.

    dev_scripts/w_colmap_n360/col_*_points.sh: same grid/query
    hyperparameters as w_n360 but the cloud comes from a COLMAP
    fused.ply (load_points=1; here `gen-points --from-ply`, view
    triples via --pairing triangles), pruning is disabled
    (prune_iter=-1), growth probes run longer (prob_num_step=50), and
    batches are 70x70 pixel samples (random_sample_size=70).
    """
    ranges = COLMAP_RANGES.get(scene, (-1.3,) * 3 + (1.3,) * 3)
    query = QueryConfig(
        vsize=(0.004, 0.004, 0.004), vscale=(2, 2, 2),
        kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        ranges=ranges, z_depth_dim=400, SR=80, K=8,
        max_o=410_000, P=12)
    cfg = PointNerfConfig(
        query=query,
        agg=AggregatorConfig(),
        train=TrainConfig(max_iterations=200_000, rays_per_batch=4900,
                          prune_iter=0, prob_freq=10_001,
                          prob_num_step=50, prob_thresh=0.7,
                          prob_mul=0.4),
        near_plane=2.0, far_plane=6.0,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def scannet_config(scene: str = "scene0241_01", **overrides) -> PointNerfConfig:
    query = QueryConfig(
        vsize=(0.008, 0.008, 0.008), vscale=(2, 2, 2),
        ranges=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0),
        z_depth_dim=400, SR=24, K=8, max_o=610_000, P=12)
    cfg = PointNerfConfig(
        query=query,
        # scene241_points.sh: no pruning, prob 10000/0.7/x0.4; ray_miss
        # tracked at weight 0 for probe-frame ranking
        train=TrainConfig(
            prob_freq=10_000, prob_thresh=0.7, prob_mul=0.4,
            color_loss_items=("ray_masked_coarse_raycolor",
                              "ray_miss_coarse_raycolor"),
            color_loss_weights=(1.0, 0.0)),
        near_plane=0.1, far_plane=8.0,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def tt_config(scene: str = "Truck", **overrides) -> PointNerfConfig:
    query = QueryConfig(
        vsize=(0.002, 0.002, 0.002), vscale=(2, 2, 2),
        ranges=(-10.0, -10.0, -10.0, 10.0, 10.0, 10.0),
        z_depth_dim=400, SR=40, K=8, max_o=1_600_000, P=12)
    cfg = PointNerfConfig(
        query=query,
        # truck_points.sh: prune_iter 10001, prob 10001/0.7/x0.4
        train=TrainConfig(prune_iter=10_001, prob_freq=10_001,
                          prob_thresh=0.7, prob_mul=0.4),
        near_plane=0.0, far_plane=3.5,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_preset(name: str) -> PointNerfConfig:
    """Look up a preset by scene name across dataset families."""
    if name in NERF_SYNTH_RANGES:
        return nerf_synth_config(name)
    if name in COLMAP_RANGES:
        return colmap_config(name)
    if name in SCANNET_SCENES:
        return scannet_config(name)
    if name in TT_SCENES or name.lower() in tuple(s.lower() for s in TT_SCENES):
        return tt_config(name)
    raise KeyError(f"unknown scene preset: {name!r}")
