"""95th percentile of (receive of block k) - (the feed call returning block
k) on the host clock, in ms: the executor's part of a block's latency,
without the wait for input. Blocks inside the profiled stretch are left
out."""

import numpy as np


def read(run):
    s = run.service_s()
    return None if not len(s) else float(np.percentile(s, 95) * 1e3)
