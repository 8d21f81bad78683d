"""device_idle_share: 1 less the union of the device's kernel, copy and
memset intervals over the traced window, in %."""


def read(r):
    if not r.trace.device_events():
        return None
    return (1.0 - r.trace.busy_s() / r.window_s) * 100
