"""verify_host_ms: a verify call's share of the window's host wall time,
less K4's mean device time: the mirror's per-call overhead (the lock,
the launch, the count back), in ms."""


def read(r):
    runs = r.trace.kernels_named("mirror_verify_kernel")
    if not runs or not r.calls:
        return None
    k4_ms = sum(e.dur for e in runs) / len(runs) / 1e3
    return r.window_s / r.calls * 1e3 - k4_ms
