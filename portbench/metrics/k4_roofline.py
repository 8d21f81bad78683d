"""k4_roofline: the least time for one verify of the whole mirror
(roofline.py) over K4's mean device time in the window, in %."""

from portbench import roofline


def read(r):
    runs = r.trace.kernels_named("mirror_verify_kernel")
    if not runs:
        return None
    bound_s, _ = roofline.verify_bound_s(int(r.config["rows"]), int(r.config["row_bytes"]))
    mean_s = sum(e.dur for e in runs) / len(runs) / 1e6
    return bound_s / mean_s * 100
