"""joint_device_ms_per_step: milliseconds a joint step in which an
operation ran on the device (forward, backward and both Adam groups),
from the profiler's trace of the traced window."""


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "joint" or not t or not w or not w["steps"]:
        return None
    return 1e3 * t["busy_s"] / w["steps"]
