"""render_rays_per_s: all pixels of all frames completed in the window
over the window's seconds (host clock, each frame's colour on the
host), in any cell whose kind's window timed frames (the record's `loop`
"frames")."""


def read(r):
    if r.get("loop") != "frames" or r["window_s"] <= 0:
        return None
    return r["frames"] * r["pixels"] / r["window_s"]
