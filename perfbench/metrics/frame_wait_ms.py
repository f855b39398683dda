"""frame_wait_ms: host milliseconds a frame blocked on the card in the
budget escalation's overflow reads (the span `render_frame.wait`), from
the program's own registry over the traced window."""

from perfbench.core import registry


def read(r):
    if r["kind"] != "frames" or not r.get("trace"):
        return None
    return registry.per("span.render_frame.wait.ns", "render_frame.frames",
                        1e-6)
