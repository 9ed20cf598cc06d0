"""The EQ kernel's share of its roofline: the least time the card needs for
the sections' work in the traced stretch (bytes per call from
:func:`portbench.peaks.biquad_section_bytes` at the cell's shapes, at the
HBM rate) over the device time of the kernels named ``biquad_*`` there. A
renamed or fused kernel leaves it unread."""

import re

from portbench import peaks

KERNEL = re.compile(r"(^|::)biquad_")


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = sum(v for k, v in t["by_name_s"].items() if KERNEL.search(k))
    if spent <= 0:
        return None
    channels, frames, sections = run.eq_shape
    least = peaks.biquad_section_least_s(channels, frames) * sections * run.trace_blocks
    return least / spent * 100.0
