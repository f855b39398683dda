"""Training state and the optimizers.

Port of `pointnerf2studio_tpu/train/trainer.py`. Two Adam groups with a
per-update exponential learning-rate decay (reference trainer config,
pointnerf/nerfstudio/studio_config.py:33-48; scheduler
studio_utils.py:33-44):

  * "fields": the MLP tower, lr 5e-4;
  * "neural_points": the point embedding, conf, dir and colour, lr 2e-3;
  * lr after n updates of a group: lr0 * lr_decay_exp ** (n / span),
    continuous, span = lr_decay_iters, halved under alter_step (each
    group then takes half the updates; the reference decays by the
    global step).

xyz, Rw2c and alive stay frozen. torch's Adam has eps outside the square
root, as optax's `adam` does. Under TrainConfig.alter_step the group that
sits a phase out keeps its parameters and its Adam moments: its `step()`
is not called, and its gradients are cleared before the next backward.
`make_train_step` is the legacy step, through `models/render.render_rays`
(the fast step is `models/fast_train.make_fast_train_step`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud


@dataclasses.dataclass
class TrainState:
    params: Aggregator                  # the tower, gradients on
    points: NeuralPointCloud            # trainable attributes as leaves
    opt_fields: torch.optim.Adam
    opt_points: torch.optim.Adam
    sched_fields: torch.optim.lr_scheduler.LambdaLR
    sched_points: torch.optim.lr_scheduler.LambdaLR
    step: int = 0                       # iterations taken

    def zero_grad(self) -> None:
        self.opt_fields.zero_grad(set_to_none=True)
        self.opt_points.zero_grad(set_to_none=True)


def make_optimizers(cfg: PointNerfConfig, fields: List[torch.Tensor],
                    points: List[torch.Tensor]):
    """((Adam, LambdaLR) of the fields, (Adam, LambdaLR) of the points):
    the schedule gives lr0 at a group's first update and lr0 *
    lr_decay_exp ** (n / span) at its update n (optax's
    exponential_decay, staircase off)."""
    t = cfg.train
    span = max(t.lr_decay_iters // (2 if t.alter_step > 0 else 1), 1)

    def group(tensors, lr0):
        opt = torch.optim.Adam(tensors, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda n: t.lr_decay_exp ** (n / span))
        return opt, sched

    return group(fields, t.lr_fields), group(points, t.lr_points)


def create_train_state(params: Aggregator, points: NeuralPointCloud,
                       cfg: PointNerfConfig) -> TrainState:
    """A train state that owns copies of `params` and of the cloud's
    trainable attributes, with gradients on; the caller's objects stay as
    they are."""
    params = copy.deepcopy(params).requires_grad_(True)
    points = points.with_trainable({
        k: v.detach().clone().requires_grad_(True)
        for k, v in points.trainable().items()})
    (opt_f, sch_f), (opt_p, sch_p) = make_optimizers(
        cfg, list(params.parameters()), list(points.trainable().values()))
    return TrainState(params=params, points=points, opt_fields=opt_f,
                      opt_points=opt_p, sched_fields=sch_f,
                      sched_points=sch_p)


def apply_updates(state: TrainState, cfg: PointNerfConfig) -> None:
    """One optimizer update from the gradients in place: both groups, or
    under alter_step the fields while (step // alter_step) % 2 == 0 and
    the points otherwise (reference backward,
    neural_points_volumetric_model.py:204-211)."""
    alt = cfg.train.alter_step
    phase = (state.step // alt) % 2 if alt > 0 else None
    for opt, sched, p in ((state.opt_fields, state.sched_fields, 0),
                          (state.opt_points, state.sched_points, 1)):
        if phase is None or phase == p:
            opt.step()
            sched.step()
    state.step += 1


def make_train_step(cfg: PointNerfConfig):
    """The legacy train step, one forward and backward of
    `render_rays(training=True)` and the losses, then the optimizer update
    (`apply_updates`):

        step(state, grid, campos, camrotc2w, raydirs, gt_rgb, near, far,
             generator=None, jitter_u=None, bg_rgb=None, gt_mask=None)
             -> (state, aux)

    `state` is updated in place and returned; `aux` holds the loss parts
    as device scalars, nothing read back to the host. Jitter draws come
    from `jitter_u` [R, D] where given, else from `generator`."""
    from pointnerf2studio_torch.models.render import render_rays
    from pointnerf2studio_torch.train.loss import compute_losses

    def train_step(state: TrainState, grid, campos, camrotc2w, raydirs,
                   gt_rgb, near, far,
                   generator: Optional[torch.Generator] = None,
                   jitter_u: Optional[torch.Tensor] = None,
                   bg_rgb: Optional[torch.Tensor] = None,
                   gt_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.zero_grad()
        out = render_rays(state.params, state.points, grid, campos,
                          camrotc2w, raydirs, near, far, cfg, training=True,
                          bg_ray_colors=bg_rgb, generator=generator,
                          jitter_u=jitter_u)
        total, aux = compute_losses(out, gt_rgb, cfg.train, gt_mask=gt_mask)
        total.backward()
        apply_updates(state, cfg)
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step
