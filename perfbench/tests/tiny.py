"""Tiny versions of the cells for the CPU tests: the same files, with the
scene, the voxels, the camera and the batch cut so that a run on the CPU
takes seconds."""

from __future__ import annotations

import copy

from perfbench.core import harness

TINY = {
    "nerf-synth-chair": {
        "scene": {"n_points": 20000},
        "query": {"vsize": [0.016, 0.016, 0.016], "z_depth_dim": 96,
                  "max_o": 200000, "max_q": 65536},
        "camera": {"height": 24, "width": 24, "focal": 33.3},
    },
    "scannet-room-staged": {
        "scene": {"n_points": 60000},
        "query": {"vsize": [0.032, 0.032, 0.032], "z_depth_dim": 96},
        "camera": {"height": 24, "width": 32, "focal": 29.0},
    },
}
TINY_TRAFFIC = {
    "train": {"rays_per_step": 128, "trace_seconds": 1.0},
    "frames": {"chunk": 256, "warmup_frames": 1, "check_rays": 256,
               "count_sample": 4, "trace_seconds": 1.0},
}


def tiny_spec(cell: str) -> harness.Spec:
    spec = harness.load(cell)
    spec = copy.deepcopy(spec)
    for sec, vals in TINY[spec.cell["config"]].items():
        spec.config[sec].update(vals)
    spec.traffic.update(TINY_TRAFFIC[spec.traffic["kind"]])
    return spec
