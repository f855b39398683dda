"""fused_decode2_roofline: the least time the card could take for the
K-accumulating tower's work on the traced frames (the larger of its
operations over the bf16 peak and its bytes over the memory peak,
counted by the benchmark's reference: the (sample, neighbour) rows within
the radius through mlp_base, mlp_head and the density head), over the
device time of `ops/fused_decode.py::fused_decode2`'s kernel
(`fused_decode_kernel<true>` of csrc/fused_decode.cu) in the trace, in
percent. Silent where that kernel did not run."""

from perfbench.core.counts import bound

KERNEL = "fused_decode_kernel<true>"


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "frames" or not t or not w or "decode2" not in w:
        return None
    s = sum(sec for name, sec in t["device_time_by_name"].items()
            if KERNEL in name)
    if s <= 0:
        return None
    flops, n_bytes = w["decode2"]
    return 100.0 * bound(n_bytes, flops)[0] / s
