"""frame_ms_p90: the 90th percentile of every frame's wall time in the
window, from the call into the renderer to its colour on the host."""

import numpy as np


def read(r):
    if r["kind"] != "frames" or not r["frame_s"]:
        return None
    return float(np.percentile(np.asarray(r["frame_s"]) * 1e3, 90))
