"""k1f_roofline: the least time for one batch's digests (roofline.py:
the sponge's operations or its bytes, whichever bounds) over K1f's mean
device time in the window, in %."""

from portbench import roofline


def read(r):
    runs = r.trace.kernels_named("keccak256_fixed_kernel")
    if not runs:
        return None
    bound_s, _ = roofline.hash_bound_s(int(r.config["rows"]), int(r.config["row_bytes"]))
    mean_s = sum(e.dur for e in runs) / len(runs) / 1e6
    return bound_s / mean_s * 100
