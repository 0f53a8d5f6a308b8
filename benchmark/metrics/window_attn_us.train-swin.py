"""window_attn_us.train-swin: device us of the ``swin.window_attention``
spans, their backward included (``regions.py``), per window the program
counted (``swin.windows``) in the traced window, in a Swin training
cell."""

from benchmark.regions import span_us_per_count


def read(rec):
    return span_us_per_count(rec, "train", "swin.window_attention",
                             "swin.windows")
