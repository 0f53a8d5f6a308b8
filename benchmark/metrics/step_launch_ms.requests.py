"""step_launch_ms.requests: the median host time of a step's call, which
launches its kernels (``session.step`` spans in the traced window), ms,
in a requests cell."""

from benchmark.spans import median_ms


def read(rec):
    return median_ms(rec, "requests", "session.step")
