"""train_rays_per_s: all rays of all train steps completed in the window
over the window's seconds (host clock, to the last step's result)."""


def read(r):
    if r["kind"] != "train" or r["window_s"] <= 0:
        return None
    return r["rays"] / r["window_s"]
