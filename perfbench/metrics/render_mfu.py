"""render_mfu: the tower operations that exact renders of the traced
frames need, counted by the benchmark's reference from the cell's inputs,
over the traced window's seconds and the card's peak in the tower's
compute dtype (`counts.peak_flops`), in percent."""

from perfbench.core.counts import peak_flops


def read(r):
    t, w = r.get("trace"), r.get("work")
    if r["kind"] != "frames" or not t or not w or t["window_s"] <= 0:
        return None
    peak = peak_flops(r["spec"].config["agg"])
    return 100.0 * w["flops"] / (t["window_s"] * peak)
