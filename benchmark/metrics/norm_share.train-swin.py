"""norm_share.train-swin: device time of the kernels launched in the
program's ``layer_norm`` spans, their backward included (``regions.py``),
over all device time in the traced window, in a Swin training cell."""

from benchmark.regions import span_share


def read(rec):
    return span_share(rec, "train", "layer_norm")
