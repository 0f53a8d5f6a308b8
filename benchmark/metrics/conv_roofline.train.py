"""conv_roofline.train: the model's convolutions' least time at the peaks
over the device time of the conv kernels, percent, in a train cell."""

from benchmark.readers import conv_roofline


def read(rec):
    return conv_roofline(rec, "train")
