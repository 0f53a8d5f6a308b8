"""pointwise_share.train: device time of elementwise, copy, layout and
reduction kernels (the "pointwise" class) over all device time, in a train
cell."""

from benchmark.readers import class_share


def read(rec):
    return class_share(rec, "train", "pointwise")
