"""idle_share.serve-int8: the share of the traced window in which the
device ran nothing (profiler records), in an int8 serve cell."""

from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "serve")
