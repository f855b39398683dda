"""frame_plan_ms: host milliseconds a frame in `render_frame`'s plan (the
span `render_frame.plan`: the host ray copy, the slab test and sort, the
raster, the output buffers, the permutation's upload and the rays'
gather), from the program's own registry over the traced window."""

from perfbench.core import registry


def read(r):
    if r["kind"] != "frames" or not r.get("trace"):
        return None
    return registry.per("span.render_frame.plan.ns", "render_frame.frames",
                        1e-6)
