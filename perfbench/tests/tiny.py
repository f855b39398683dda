"""Tiny versions of the cells for the CPU tests: the same files, with the
scene, the voxels, the camera and the batch cut so that a run on the CPU
takes seconds. A configuration's cut is `perfbench/tiny/<config>.json`
(each section's settings over the configuration's), a traffic kind's its
module's `TINY_TRAFFIC`."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench.core import harness


def tiny_spec(cell: str, root: Path = harness.ROOT) -> harness.Spec:
    spec = copy.deepcopy(harness.load(cell, root))
    cut = root / "perfbench" / "tiny" / f"{spec.cell['config']}.json"
    for sec, vals in json.loads(cut.read_text()).items():
        spec.config[sec].update(vals)
    spec.traffic.update(harness.kind(spec.traffic["kind"]).TINY_TRAFFIC)
    return spec
