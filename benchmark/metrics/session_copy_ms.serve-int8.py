"""session_copy_ms.serve-int8: the median over the traced window's
batches of the session's copies (frames in, labels out, the labels' cast
to uint8: ``session.copy_in`` + ``session.labels_out`` +
``session.cast``), ms, in an int8 serve cell."""

from benchmark.spans import per_request_median_ms


def read(rec):
    return per_request_median_ms(rec, "serve")
