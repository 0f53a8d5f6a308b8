"""lock_wait_ms.requests: the mean time a step waited for the serving
session's step lock (``session.lock_wait`` spans in the traced window),
ms, in a requests cell. A mean: a 5-s traced window holds ~90 requests,
too few for a tail."""

from benchmark.spans import mean_ms


def read(rec):
    return mean_ms(rec, "requests", "session.lock_wait")
