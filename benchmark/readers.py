"""Reductions the per-layer metric readers share. Each takes the run's
record (``rec``: the driver's window record with the trace summary, the
conv work of one call, the peaks and the configuration) and the kind of
cell the metric belongs to, and returns None where the record has
nothing to read: another kind of cell, no trace, or no kernel of the
class.
"""

from __future__ import annotations

from benchmark.work.onet import bound_seconds, ideal_seconds


def _summary(rec, kind):
    if rec.get("kind") != kind:
        return None
    return rec.get("summary")


def idle_share(rec, kind):
    """The share of the traced window in which no device record ran."""
    s = _summary(rec, kind)
    if not s or s["window_s"] <= 0:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]


def class_share(rec, kind, cls):
    """A class's device time over all device time in the window."""
    s = _summary(rec, kind)
    if not s or s["device_s"] <= 0:
        return None
    return s["by_class"].get(cls, 0.0) / s["device_s"]


def conv_roofline(rec, kind):
    """Percent: the conv work's least time (``work/onet.py``) over the
    device time of the kernels in the "conv" class."""
    s = _summary(rec, kind)
    t = s and s["by_class"].get("conv", 0.0)
    if not t:
        return None
    return 100.0 * bound_seconds(rec["work"], rec["peaks"]) * rec["calls"] / t


def step_mfu(rec, kind):
    """Percent: the model's operations done in the window, each over its
    precision's peak, over the window's length."""
    s = _summary(rec, kind)
    if not s or rec["calls"] == 0:
        return None
    return (100.0 * ideal_seconds(rec["work"], rec["peaks"]) * rec["calls"]
            / s["window_s"])


def peak_gib(rec, kind):
    if rec.get("kind") != kind or not rec.get("window_peak_bytes"):
        return None
    return rec["window_peak_bytes"] / 2 ** 30
