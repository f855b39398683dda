"""The cell's inputs, made from the seed by the benchmark's own code: the
cloud, the tower's weights, the camera poses and the train views. Both
the program and the reference are handed these."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core import scenes
from perfbench.reference.pointnerf import n_weights, split_weights


def sub_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed."""
    return np.random.default_rng([seed, stream])


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_cloud(config: dict, seed: int, device) -> dict:
    """{xyz, emb, conf, dir, color} float32 tensors on `device` of the
    configuration's scene. The scene's geometry (and the points' colours
    and directions) comes from the configuration's own `scene.seed`, so
    every run seed renders and trains on the same amount of work; the
    points' 0.1-scale random embeddings come from the run seed, drawn by a
    torch.Generator on `device`."""
    sc = config["scene"]
    if sc["kind"] == "chair":
        q = config["query"]
        arrs = scenes.chair_points(
            sc["n_points"], sc["seed"], q["vsize"][2] * q["vscale"][2],
            sc["jitter_sigma_voxels"], device)
    elif sc["kind"] == "room":
        arrs = scenes.room_cloud(sc["n_points"], sc["seed"])
    else:
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    cloud = {k: torch.as_tensor(v, device=device) for k, v in arrs.items()}
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 0))
    cloud["emb"] = torch.randn(cloud["emb"].shape, generator=g,
                               device=device) * 0.1
    return cloud


def make_weights(config: dict, seed: int, device) -> dict:
    """The tower's weights from one uniform draw of a torch.Generator on
    `device`: {tower: [(W [out, in], b [out])]} float32 (the bounds of
    `reference.pointnerf.split_weights`), the density head's bias raised
    by the configuration's `density_bias` (without it the density's ReLU
    is off on most samples)."""
    agg = config["agg"]
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 1))
    flat = torch.rand(n_weights(agg), generator=g, device=device)
    w = split_weights(flat, agg)
    wd, bd = w["density_head"][0]
    w["density_head"][0] = (wd, bd + config["weights"]["density_bias"])
    return w


def make_poses(traffic: dict, seed: int) -> list:
    """The traffic's camera poses (c2w [4, 4]): `n_poses` azimuths evenly
    spaced, the same for every seed (so that every seed renders the same
    work), in an order drawn from the seed."""
    p = traffic["poses"]
    rng = sub_rng(seed, 2)
    n = p["n_poses"]
    az = ((np.arange(n) + 0.5) * (360.0 / n))[rng.permutation(n)]
    if p["kind"] == "ring":
        return [scenes.ring_pose(a, p["elevation_deg"], p["radius"])
                for a in az]
    if p["kind"] == "room_level":
        return [scenes.room_pose(a, p["back_m"], p["height_m"]) for a in az]
    raise ValueError(f"unknown pose kind {p['kind']!r}")


def make_views(config: dict, traffic: dict, seed: int, device):
    """The train views: (images [V, H, W, 3] float32 on `device`, poses
    [V, 4, 4]) on the ring at evenly spaced azimuths, the same for every
    seed; each image a smooth colour ramp drawn from the seed."""
    cam = config["camera"]
    H, W = cam["height"], cam["width"]
    n = traffic["views"]
    rng = sub_rng(seed, 3)
    az = (np.arange(n) + 0.5) * (360.0 / n)
    poses = np.stack([scenes.ring_pose(a, traffic["elevation_deg"])
                      for a in az])
    coef = torch.as_tensor(rng.uniform(0.1, 0.9, (n, 3, 3)),
                           dtype=torch.float32, device=device)
    ys = torch.linspace(0, 1, H, device=device)[:, None, None]
    xs = torch.linspace(0, 1, W, device=device)[None, :, None]
    imgs = torch.stack([
        (coef[v, 0] * 0.5 + coef[v, 1] * 0.5 * xs
         + coef[v, 2] * 0.5 * ys).clamp(0, 1) for v in range(n)])
    return imgs.contiguous(), poses


class Sampler:
    """Ray batches drawn on the device: one view and `rays` integer pixels
    of it a step, from a torch.Generator (a copy of the program's
    `train/loop.py::DeviceSampler` draws, so that a batch is what `fit()`
    would feed), and the step's jitter draws [rays, D]."""

    def __init__(self, imgs, poses, focal: float, rays: int, D: int,
                 seed: int):
        dev = imgs.device
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(torch_seed(seed, 4))
        self.imgs, self.B, self.D = imgs, rays, D
        self.V, self.H, self.W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
        self.f = float(focal)
        self.campos = torch.as_tensor(poses[:, :3, 3], dtype=torch.float32,
                                      device=dev)
        self.camrot = torch.as_tensor(poses[:, :3, :3], dtype=torch.float32,
                                      device=dev)

    def next(self):
        """(campos [3], camrotc2w [3, 3], raydirs [B, 3], gt [B, 3],
        jitter_u [B, D]) on the device."""
        g, dev = self.g, self.g.device
        view = torch.randint(self.V, (), generator=g, device=dev)
        xs = torch.randint(self.W, (self.B,), generator=g, device=dev)
        ys = torch.randint(self.H, (self.B,), generator=g, device=dev)
        gt = self.imgs[view, ys, xs]
        x = (xs.to(torch.float32) + 0.5 - self.W / 2) / self.f
        y = (ys.to(torch.float32) + 0.5 - self.H / 2) / self.f
        camrot = self.camrot[view]
        v = torch.stack([x, y, torch.ones_like(x)], -1)
        dirs = (v[:, None, :] * camrot[None]).sum(-1)
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-5)
        u = torch.rand((self.B, self.D), generator=g, device=dev)
        return self.campos[view], camrot, dirs, gt, u
