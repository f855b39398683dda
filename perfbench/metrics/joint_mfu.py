"""joint_mfu: the operations that exact joint MVS steps of these batches
need (forward and backward: FeatureNet over every view, CostRegNet and
ProbNet over the cost volume, the premlp over the generated points, and
the render's rows and slots as `train_mfu` counts them), counted from
the benchmark's reference on the cell's inputs (`core/mvs_counts.py`,
`core/counts.py`), over the traced window's seconds and the card's
float32 peak, in percent."""

from perfbench.core.counts import PEAK_FLOPS_OF


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "joint" or not t or not w or t["window_s"] <= 0:
        return None
    return 100.0 * w["flops"] / (t["window_s"] * PEAK_FLOPS_OF["float32"])
