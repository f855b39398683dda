"""joint_host_ms_per_step: host milliseconds a step inside the joint step
(the span `joint.step`: zero_grad, the forward's phases, backward and
both Adam groups, with the host's waits for the card inside them), from
the program's own registry over the traced window. Silent where the
program has no such span."""

from perfbench.core import registry


def read(r):
    if r["kind"] != "joint" or not r.get("trace"):
        return None
    return registry.per("span.joint.step.ns", "joint.steps", 1e-6)
