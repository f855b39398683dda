"""device_idle_share.frames: the share of the traced window in which no
operation ran on the device, in percent."""


def read(r):
    t = r.get("trace")
    if r["kind"] != "frames" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
