"""train_host_ms_per_step: host milliseconds a step inside the train
step (the span `train.step`: zero_grad, forward, losses, backward and
optimizer, with the host's waits for the card inside them), from the
program's own registry over the traced window."""

from perfbench.core import registry


def read(r):
    if r["kind"] != "train" or not r.get("trace"):
        return None
    return registry.per("span.train.step.ns", "train.steps", 1e-6)
