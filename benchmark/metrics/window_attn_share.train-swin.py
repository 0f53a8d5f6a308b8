"""window_attn_share.train-swin: device time of the kernels launched in
the program's ``swin.window_attention`` spans, their backward included
(``regions.py``), over all device time in the traced window, in a Swin
training cell."""

from benchmark.regions import span_share


def read(rec):
    return span_share(rec, "train", "swin.window_attention")
