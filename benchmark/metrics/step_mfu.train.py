"""step_mfu.train: the model's operations done in the traced window, each
over its precision's peak, over the window, percent, in a train cell."""

from benchmark.readers import step_mfu


def read(rec):
    return step_mfu(rec, "train")
