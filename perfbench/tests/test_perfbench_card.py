"""On the card (marked `cuda`, skipped elsewhere): each cell's whole run at
its own size, short, comes out correct; the control (the reference in the
nearest precision below the configuration's tower, in the program's
place) at the cell's own size does not.

    python -m pytest -q -n 0 -p no:cacheprovider -m cuda perfbench/tests
"""

import time

import pytest
import torch

from perfbench.core import harness
from perfbench.kinds import frames as fk
from perfbench.kinds import train as tk
from perfbench.reference import pointnerf as ref

CELLS = ("chair-train", "room-frames-staged")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_run_is_correct(card, cell):
    line = harness.run(harness.load(cell), 2 ** 31 + 99, 3.0, False, card,
                       time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    spec = harness.load(cell)
    low = ref.control_precision(spec.config["agg"])
    if spec.traffic["kind"] == "train":
        c = tk.Train(spec, 777, card)
        c.batches = [c.sampler.next()
                     for _ in range(spec.traffic["check_steps"])]
        got = tk.gaps(c.reference(low), c.reference())
    else:
        c = fk.Frames(spec, 777, card)
        kept = [(i, None) for i in range(spec.traffic["check_frames"])]
        got = c.compare(kept, precision=low, against="reference")
    assert any(not got[k] <= lim for k, lim in spec.limits.items()), got
