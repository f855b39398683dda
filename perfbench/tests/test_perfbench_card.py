"""On the card (marked `cuda`, skipped elsewhere): each cell's whole run at
its own size, short, comes out correct; the control (the reference in the
nearest precision below the configuration's tower, in the program's
place) at the cell's own size does not.

    python -m pytest -q -n 0 -p no:cacheprovider -m cuda perfbench/tests
"""

import json
import time

import pytest
import torch

from perfbench.core import harness

# every cell of BENCHMARK.json, a cell that a later change adds with it
CELLS = tuple(w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"])


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
    got = harness.kind(spec.traffic["kind"]).readings(spec, 777, card,
                                                      "control")
    assert any(not got[k] <= lim for k, lim in spec.limits.items()), got
