"""One reader per metric, found by the part of the metric's name before its
first dot (a metric ``x.live`` would be read by ``x``).

A reader is ``read(run) -> float | None`` over the :class:`portbench.harness.Run`
of one run. It returns None where it finds nothing to read, and the harness
then leaves the metric out of the result line.
"""
