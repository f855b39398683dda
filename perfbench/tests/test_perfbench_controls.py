"""The check comes out not correct for the control and for each fault a
cell can have, at the CPU tests' size: the reference in the nearest
precision below the configuration's tower in the program's place (TF32
for the float32 chair, float8 for the bfloat16 room), a train step that
leaves its state unchanged, a train step on half of its batch (the mean
over the rest), a frame whose answer is altered where it is produced.
The faults are planted under a whole run of the harness (`harness.run`
past the look for a card)."""

import time

import pytest
import torch

from perfbench.core import harness
from perfbench.kinds import frames as fk
from perfbench.kinds import train as tk
from perfbench.reference import pointnerf as ref
from perfbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")


def _fails(readings: dict, limits: dict) -> bool:
    return any(not readings[k] <= lim for k, lim in limits.items())


@pytest.mark.parametrize("seed", [101, 202])
def test_train_control_is_not_correct(seed):
    spec = tiny_spec("chair-train")
    cell = tk.Train(spec, seed, CPU)
    cell.batches = [cell.sampler.next()
                    for _ in range(spec.traffic["check_steps"])]
    got = tk.gaps(cell.reference(ref.control_precision(spec.config["agg"])),
                  cell.reference())
    assert _fails(got, spec.limits), got


@pytest.mark.parametrize("seed", [101, 202])
def test_frames_control_is_not_correct(seed):
    spec = tiny_spec("room-frames-staged")
    cell = fk.Frames(spec, seed, CPU)
    kept = [(i, None) for i in range(spec.traffic["check_frames"])]
    got = cell.compare(kept, against="reference",
                       precision=ref.control_precision(spec.config["agg"]))
    assert _fails(got, spec.limits), got


def _run(cell: str, plant) -> dict:
    return harness.run(tiny_spec(cell), 31, 0.3, False, CPU,
                       time.perf_counter(), hooks={"program": plant})


def test_sound_runs_are_correct():
    for cell in ("chair-train", "room-frames-staged"):
        assert _run(cell, lambda c: None)["correct"], cell


def test_train_state_unchanged_is_not_correct():
    def plant(cell):
        def step(state, *a, **k):
            return state, {"total": torch.zeros(())}
        cell.step_fn = step
    line = _run("chair-train", plant)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct():
    def plant(cell):
        step = cell.step_fn

        def half(state, grid, campos, camrot, rd, gt, near, far, **k):
            n = rd.shape[0] // 2
            u = k.pop("jitter_u")[:n]
            return step(state, grid, campos, camrot, rd[:n], gt[:n], near,
                        far, jitter_u=u, **k)
        cell.step_fn = half
    assert not _run("chair-train", plant)["correct"]


def test_frame_answer_altered_is_not_correct():
    def plant(cell):
        render = cell.render

        def altered(*a, **k):
            out = render(*a, **k)
            out.coarse_raycolor[:, 0] += 0.05
            return out
        cell.render = altered
    assert not _run("room-frames-staged", plant)["correct"]
