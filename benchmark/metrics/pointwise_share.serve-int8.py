"""pointwise_share.serve-int8: device time of elementwise, copy, layout
and reduction kernels (the "pointwise" class) over all device time, in
an int8 serve cell."""

from benchmark.readers import class_share


def read(rec):
    return class_share(rec, "serve", "pointwise")
