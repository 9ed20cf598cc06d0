"""Kernel launch and ``cudaMemcpyAsync`` calls in the traced stretch, per
block: the host's dispatch work."""


def read(run):
    t = run.trace
    if t is None or t["launches"] == 0:  # no CUDA call seen: nothing was read
        return None
    return t["launches"] / run.trace_blocks
