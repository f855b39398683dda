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

Structure changes act on the state in place: `set_points` writes a new
cloud's values into the state's trainable tensors (the ones the points
group owns), `reset_point_opt_slots` zeroes the Adam moments of grown
slots, and `expand_state_capacity` re-pads the cloud and its moments,
moving each tensor's Adam state to its padded successor
(`rebind_points`, which parallel/sharding.py also uses to cut a state
into a rank's rows and put it together again).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from pointnerf2studio_torch.config import PointNerfConfig
from pointnerf2studio_torch.models.aggregator import Aggregator
from pointnerf2studio_torch.models.neural_points import NeuralPointCloud
from pointnerf2studio_torch.utils import profiling


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
    from `jitter_u` [R, D] where given, else from `generator`. While a
    profiler records (utils/profiling.py), the step is the span
    `train.step`, its phases `train.forward`, `train.loss`,
    `train.backward` and `train.optimizer` (`zero_grad` is the step's own
    time), and `train.steps` counts."""
    from pointnerf2studio_torch.models.render import render_rays
    from pointnerf2studio_torch.train.loss import compute_losses

    def train_step(state: TrainState, grid, campos, camrotc2w, raydirs,
                   gt_rgb, near, far,
                   generator: Optional[torch.Generator] = None,
                   jitter_u: Optional[torch.Tensor] = None,
                   bg_rgb: Optional[torch.Tensor] = None,
                   gt_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        profiling.count("train.steps")
        with profiling.span("train.step", f"step={state.step}"):
            state.zero_grad()
            with profiling.span("train.forward"):
                out = render_rays(state.params, state.points, grid, campos,
                                  camrotc2w, raydirs, near, far, cfg,
                                  training=True, bg_ray_colors=bg_rgb,
                                  generator=generator, jitter_u=jitter_u)
            with profiling.span("train.loss"):
                total, aux = compute_losses(out, gt_rgb, cfg.train,
                                            gt_mask=gt_mask)
            with profiling.span("train.backward"):
                total.backward()
            with profiling.span("train.optimizer"):
                apply_updates(state, cfg)
            return state, {k: v.detach() for k, v in aux.items()}

    return train_step


@torch.no_grad()
def set_points(state: TrainState, points: NeuralPointCloud) -> None:
    """Make `points` (same capacity) the state's cloud: its trainable
    values are copied into the tensors the points group optimises, its
    frozen fields (xyz, Rw2c, alive) replace the state's."""
    for name, t in state.points.trainable().items():
        t.copy_(getattr(points, name))
    state.points = points.with_trainable(state.points.trainable())


@torch.no_grad()
def reset_point_opt_slots(opt_points: torch.optim.Adam,
                          slots: torch.Tensor) -> None:
    """Zero the first and second Adam moments at the rows `slots` of every
    tensor of the points group (a grown slot's history belonged to a
    pruned point). The step counts stay, as optax's count does."""
    for group in opt_points.param_groups:
        for p in group["params"]:
            st = opt_points.state.get(p)
            if not st:
                continue
            for k in ("exp_avg", "exp_avg_sq"):
                st[k][slots.to(st[k].device)] = 0.0


MOMENTS = ("exp_avg", "exp_avg_sq")


@torch.no_grad()
def rebind_points(state: TrainState, points: NeuralPointCloud,
                  moment_fn) -> None:
    """Make `points` the state's cloud: its trainable tensors (copied,
    with gradients on) take the place of the points group's tensors, each
    taking over its predecessor's Adam state with the two moments mapped
    by `moment_fn` and the step count kept; the schedulers stay."""
    old = state.points.trainable()
    new = {k: v.detach().clone().requires_grad_(True)
           for k, v in points.trainable().items()}
    swap = {id(old[k]): new[k] for k in old}
    opt = state.opt_points
    for group in opt.param_groups:
        for i, p in enumerate(group["params"]):
            q = swap[id(p)]
            st = opt.state.pop(p, None)
            if st:
                opt.state[q] = {k: (moment_fn(v) if k in MOMENTS else v)
                                for k, v in st.items()}
            group["params"][i] = q
    state.points = points.with_trainable(new)


@torch.no_grad()
def expand_state_capacity(state: TrainState, new_capacity: int) -> None:
    """Re-pad the cloud to `new_capacity` rows (`expand_capacity`) and its
    Adam moments with zero rows (`rebind_points`); the step counts and the
    scheduler's position are kept."""
    from pointnerf2studio_torch.models.neural_points import expand_capacity
    pad = new_capacity - state.points.capacity
    rebind_points(state, expand_capacity(state.points, new_capacity),
                  lambda v: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]))
