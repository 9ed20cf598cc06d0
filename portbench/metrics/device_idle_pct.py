"""Share of the traced stretch's wall time in which no kernel, copy or fill
ran on the device (its own timeline: 1 - union of their intervals / wall)."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
