"""step_mfu.serve-int8: the model's operations done in the traced window,
each over its precision's peak, over the window, percent, in an int8
serve cell."""

from benchmark.readers import step_mfu


def read(rec):
    return step_mfu(rec, "serve")
