"""idle_share.requests: the share of the traced window in which the device
ran nothing (profiler records), in a requests cell. The cell offers a
fixed rate, so the device's work a request sets it: a step that does less
work leaves the device idle longer, and higher is better."""

from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "requests")
