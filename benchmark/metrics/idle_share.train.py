"""idle_share.train: the share of the traced window in which the device
ran nothing (profiler records), in a train cell."""

from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "train")
