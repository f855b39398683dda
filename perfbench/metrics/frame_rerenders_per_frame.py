"""frame_rerenders_per_frame: chunk renders a frame that the budget
escalation repeats at a doubled budget (the counter
`render_frame.rerenders`), from the program's own registry over the
traced window."""

from perfbench.core import registry


def read(r):
    if r["kind"] != "frames" or not r.get("trace"):
        return None
    return registry.per("render_frame.rerenders", "render_frame.frames")
