"""Checkpoints: the reference's torch `.pth` interchange and the port's
native train-state checkpoint.

Port of `pointnerf2studio_tpu/utils/checkpoint_io.py`. The interchange is
the reference's `<iter>_net_ray_marching.pth` state dict (reference
pointnerf/models/base_model.py:85-120):
  * aggregator weights: aggregator.block1 / block3 / alpha_branch /
    color_branch .<2i>.{weight, bias} (torch Linear, weight [out, in]),
    the colour branch's last layer being the port's `color_head`;
  * neural points: neural_points.{xyz, points_embeding, points_conf,
    points_dir, points_color, Rw2c}, live points only, the points_*
    tensors with a leading batch dimension of 1, Rw2c transposed (the
    reference right-multiplies row vectors by Rw2c^T, the port by Rw2c).
It also writes and reads the `<iter>_states.pth` sidecar.

The native checkpoint is one `torch.save` of the whole train state: the
aggregator's state_dict, the point cloud's tensors (alive and capacity
included), both Adam state_dicts, both schedulers and `step`, in
`<out_dir>/ckpt/step_<n>/state.pt`. It is the port's own format: the
JAX package's native checkpoints (orbax) and the port's cannot read each
other. The `.pth` export is the interchange between the two.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.neural_points import (
    NeuralPointCloud, from_arrays)
from pointnerf2studio_torch.ops._cuda import resolve_device

# reference key prefix -> the port's towers (the colour branch is
# mlp_color followed by color_head's one layer)
TOWER_KEYS = (("aggregator.block1", ("mlp_base",)),
              ("aggregator.block3", ("mlp_head",)),
              ("aggregator.alpha_branch", ("density_head",)),
              ("aggregator.color_branch", ("mlp_color", "color_head")))
POINT_FIELDS = ("xyz", "points_embeding", "points_conf", "points_dir",
                "points_color", "Rw2c", "alive")
STATE_FILE = "state.pt"


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A .pth state dict as plain numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def _collect_tower(sd: Dict[str, np.ndarray], prefix: str):
    """The Linear layers `prefix.<i>.{weight, bias}` in the order of i."""
    idxs = sorted({int(k.split(".")[-2]) for k in sd
                   if k.startswith(prefix + ".") and k.endswith(".weight")})
    return [(sd[f"{prefix}.{i}.weight"], sd[f"{prefix}.{i}.bias"])
            for i in idxs]


@torch.no_grad()
def import_aggregator_params(sd: Dict[str, np.ndarray], cfg, device=None
                             ) -> Aggregator:
    """The reference's `aggregator.*` weights in an Aggregator of
    AggregatorConfig `cfg` on `device` (None: the card); raises where a
    tower is missing or a layer does not fit."""
    device = resolve_device(device)
    agg = Aggregator(cfg, device=device)
    for prefix, names in TOWER_KEYS:
        layers = _collect_tower(sd, prefix)
        own = [lin for n in names for lin in getattr(agg, n)]
        if not layers or len(layers) != len(own):
            raise ValueError(f"{prefix}: {len(layers)} layers in the state "
                             f"dict, {len(own)} in the config")
        for lin, (w, b) in zip(own, layers):
            if tuple(w.shape) != tuple(lin.weight.shape):
                raise ValueError(f"{prefix}: weight {tuple(w.shape)} does "
                                 f"not fit Linear{tuple(lin.weight.shape)}")
            lin.weight.copy_(torch.as_tensor(w, dtype=torch.float32))
            lin.bias.copy_(torch.as_tensor(b, dtype=torch.float32))
    return agg


def import_neural_points(sd: Dict[str, np.ndarray],
                         capacity: Optional[int] = None, device=None
                         ) -> NeuralPointCloud:
    """The reference's `neural_points.*` tensors as a cloud on `device`,
    padded to `capacity`; Rw2c transposed at the boundary."""
    def get(name):
        a = sd[f"neural_points.{name}"]
        return a[0] if a.ndim == 3 and a.shape[0] == 1 else a

    xyz = sd["neural_points.xyz"]
    if xyz.ndim == 3:
        xyz = xyz[0]
    rw2c = sd.get("neural_points.Rw2c", np.eye(3, dtype=np.float32))
    return from_arrays(
        xyz=xyz, points_embeding=get("points_embeding"),
        points_conf=get("points_conf"), points_dir=get("points_dir"),
        points_color=get("points_color"),
        Rw2c=np.swapaxes(np.asarray(rw2c), -1, -2), capacity=capacity,
        device=device)


def export_torch_checkpoint(params: Aggregator,
                            points: Optional[NeuralPointCloud],
                            path: str) -> None:
    """Write a reference-compatible `*_net_ray_marching.pth`: the towers
    and the live points (the reference has no dead slots)."""
    sd: Dict[str, Any] = {}
    for prefix, names in TOWER_KEYS:
        own = [lin for n in names for lin in getattr(params, n)]
        for i, lin in enumerate(own):
            sd[f"{prefix}.{2 * i}.weight"] = lin.weight.detach().cpu().clone()
            sd[f"{prefix}.{2 * i}.bias"] = lin.bias.detach().cpu().clone()
    if points is not None:
        alive = points.alive.cpu()

        def live(a):
            return a.detach().cpu()[alive].clone()

        sd["neural_points.xyz"] = live(points.xyz)
        for name in ("points_embeding", "points_conf", "points_dir",
                     "points_color"):
            sd[f"neural_points.{name}"] = live(getattr(points, name))[None]
        rw2c = points.Rw2c.detach().cpu()
        if rw2c.ndim == 3:              # per point: live rows only
            rw2c = rw2c[alive]
        sd["neural_points.Rw2c"] = rw2c.transpose(-1, -2).contiguous()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(sd, path)


def load_reference_checkpoint(path: str, cfg, capacity: Optional[int] = None,
                              device=None
                              ) -> Tuple[Aggregator, Optional[NeuralPointCloud]]:
    """One call: a reference `*_net_ray_marching.pth` as (Aggregator of
    AggregatorConfig `cfg`, cloud or None) on `device`."""
    sd = load_torch_state_dict(path)
    params = import_aggregator_params(sd, cfg, device=device)
    points = None
    if "neural_points.xyz" in sd:
        points = import_neural_points(sd, capacity=capacity, device=device)
    return params, points


def export_states_file(path: str, epoch_count: int, total_steps: int,
                       best_PSNR: float = 0.0, best_iter: int = 0) -> None:
    """Write the reference's `<iter>_states.pth` sidecar (base_model.py:
    85-102)."""
    torch.save({"epoch_count": epoch_count, "total_steps": total_steps,
                "best_PSNR": best_PSNR, "best_iter": best_iter}, path)


def load_states_file(path: str) -> Dict[str, Any]:
    d = torch.load(path, map_location="cpu", weights_only=False)
    return {k: (v.item() if hasattr(v, "item") else v) for k, v in d.items()}


# ---- the port's native checkpoint

def save_train_state(ckpt_dir: str, state, step: int) -> None:
    """Write `state` to `ckpt_dir/step_<step>/state.pt`, replacing an
    earlier save of the same step (a restarted run may reach it again)."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    pts = state.points
    torch.save({
        "step": int(state.step),
        "params": {k: v.detach().cpu()
                   for k, v in state.params.state_dict().items()},
        "points": {k: getattr(pts, k).detach().cpu() for k in POINT_FIELDS},
        "opt_fields": state.opt_fields.state_dict(),
        "opt_points": state.opt_points.state_dict(),
        "sched_fields": state.sched_fields.state_dict(),
        "sched_points": state.sched_points.state_dict(),
    }, os.path.join(path, STATE_FILE))


def restore_train_state(ckpt_dir: str, step: int, template,
                        cfg: PointNerfConfig):
    """The train state saved at `step`, on the device of `template` (a
    TrainState of the same config, whose aggregator gives the module
    layout): weights, the cloud at its saved capacity, both Adam states
    with their step counts, both schedulers and `step`."""
    from pointnerf2studio_torch.train.trainer import create_train_state
    dev = template.points.xyz.device
    # read to the host: load_state_dict moves each tensor to its
    # parameter's device and keeps Adam's step counts on the host, where
    # the optimizer keeps them
    d = torch.load(os.path.join(os.path.abspath(ckpt_dir), f"step_{step}",
                                STATE_FILE), map_location="cpu",
                   weights_only=True)
    template.params.load_state_dict(d["params"])
    points = NeuralPointCloud(**{k: v.to(dev) for k, v in d["points"].items()})
    state = create_train_state(template.params, points, cfg)
    state.opt_fields.load_state_dict(d["opt_fields"])
    state.opt_points.load_state_dict(d["opt_points"])
    state.sched_fields.load_state_dict(d["sched_fields"])
    state.sched_points.load_state_dict(d["sched_points"])
    state.step = d["step"]
    return state


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_")]
    return max(steps) if steps else None
