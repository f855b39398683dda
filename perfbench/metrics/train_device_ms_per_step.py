"""train_device_ms_per_step: milliseconds a step in which an operation
ran on the device (forward, backward and optimizer), from the profiler's
trace of the traced window."""


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "train" or not t or not w or not w["steps"]:
        return None
    return 1e3 * t["busy_s"] / w["steps"]
