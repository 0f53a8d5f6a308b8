"""Readings of the program's own spans (``onet_tpu_torch/utils/profiling.py``)
in the traced window, shared by the serving-session metric readers.

The window is the only profiled stretch of a run, so the records of the
program's latest profiler session are the window's. Each reduction
returns None where there is nothing to read: another kind of cell, no
span of the name in the window, or a program from before the recorder
(the benchmark's new files also run over older checkouts of the port).
"""

from __future__ import annotations

import statistics

from onet_tpu_torch.utils import profiling

COPIES = ("session.copy_in", "session.labels_out", "session.cast")


def window_spans(rec, kind):
    """The records of the program's latest profiler session, or None."""
    if rec.get("kind") != kind:
        return None
    read = getattr(profiling, "profiled_spans", None)
    return (read() or None) if read else None


def _durations_ms(rec, kind, name):
    spans = window_spans(rec, kind)
    ms = [r.ms for r in spans or () if r.name == name]
    return ms or None


def mean_ms(rec, kind, name):
    """The mean duration of the window's spans ``name``, ms."""
    ms = _durations_ms(rec, kind, name)
    return statistics.fmean(ms) if ms else None


def median_ms(rec, kind, name):
    """The median duration of the window's spans ``name``, ms."""
    ms = _durations_ms(rec, kind, name)
    return statistics.median(ms) if ms else None


def per_request_median_ms(rec, kind, names=COPIES):
    """The median over the window's requests of the summed durations of
    their spans named in ``names``, ms. A request is one ``segment`` call
    whose ``session.segment`` span opened in the window; all its spans
    count, those that opened after the window too, and a call that began
    before the window is left out: each request counts whole or not."""
    spans = window_spans(rec, kind)
    inside = {r.request for r in spans or () if r.name == "session.segment"}
    total = {}
    for r in profiling.spans() if inside else ():
        if r.request in inside and r.name in names:
            total[r.request] = total.get(r.request, 0) + (r.end - r.start)
    return statistics.median(total.values()) / 1e6 if total else None
