"""costvol_roofline: the least time the card could take for the joint
step's forward cost-volume build (its bytes over the memory peak: the
[D, H/4, W/4, 3V + 32] float32 volume written once and every view's
1/4-resolution features and colours read once, `core/mvs_counts.py`),
over the device time inside the device-side ranges that torch.profiler
mirrors for the program's span `joint.cost_volume`, in percent. The same
work whatever builds it; silent where the program has no such span or
the trace holds no device time inside it."""

from perfbench.core.counts import PEAK_BYTES


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "joint" or not t or not w:
        return None
    s = t.get("costvol_device_s", 0.0)
    if s <= 0:
        return None
    return 100.0 * w["costvol_bytes"] / PEAK_BYTES / s
