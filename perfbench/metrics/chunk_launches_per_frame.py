"""chunk_launches_per_frame: chunk renders a frame (render_frame's chunks
and its budget escalation's re-renders), from the program's own launch
counter over the traced window: the fused chunk's launches, or on the
staged route the selection kernel's, one a chunk render."""

ENTRIES = ("fused_chunk_decode", "fused_chunk_decode_any",
           "fused_candidate_select", "fused_candidate_select_any")


def read(r):
    t = r.get("trace")
    if r["kind"] != "frames" or not t or not r["frames"]:
        return None
    n = sum(t["program_launches"].get(k, 0) for k in ENTRIES)
    return n / r["frames"] if n else None
