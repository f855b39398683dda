"""train_launches_per_step: device operations (kernels, copies, fills)
launched a step, from the profiler's trace of the traced window."""


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "train" or not t or not w or not w["steps"]:
        return None
    return t["launches"] / w["steps"]
