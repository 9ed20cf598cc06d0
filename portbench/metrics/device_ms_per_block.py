"""Device time of kernels, copies and fills in the traced stretch, per
block, in ms."""


def read(run):
    t = run.trace
    if t is None or t["device_s"] <= 0:
        return None
    return t["device_s"] / run.trace_blocks * 1e3
