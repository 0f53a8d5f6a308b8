"""Device time by the program's spans, from a traced window's events.

A span of the program (``onet_tpu_torch/utils/profiling.py::span``) is,
on the profiler's thread, a ``user_annotation`` range of the Chrome
trace. Each device record (a kernel, copy or fill) is matched by its
correlation id to the host call that launched it. The launch goes to the
innermost ``user_annotation`` range that encloses it on its thread. A
launch inside an autograd backward node (a ``cpu_op`` whose ``Fwd thread
id`` is not 0) goes, where no range inside that node is closer, to the
span of the forward op with the same ``Sequence number``: the backward
pass counts with the span whose forward made the node. Sequence numbers
count per forward thread; where two forward threads share one, the
forward op that started last before the node is taken. A launch in
neither goes to no span.

``reduce(events)`` returns {span name: device seconds}; empty where the
trace has no ``user_annotation`` range (a program without spans).
"""

from __future__ import annotations

import bisect

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _args(e):
    return e.get("args") or {}


def _corr(e):
    return _args(e).get("correlation")


def reduce(events) -> dict:
    """{span name: device seconds of the records it launched}."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = [e for e in xs if e.get("cat") == "user_annotation"]
    if not ranges:
        return {}
    dev = {}
    for e in xs:
        if e.get("cat") in DEVICE_CATS and _corr(e) is not None:
            dev[_corr(e)] = dev.get(_corr(e), 0.0) + e["dur"] / 1e6
    launches = [e for e in xs if e.get("cat") in LAUNCH_CATS
                and _corr(e) in dev]
    ops = [e for e in xs if e.get("cat") == "cpu_op"
           and _args(e).get("Sequence number") is not None]
    fwd = [e for e in ops if not _args(e).get("Fwd thread id")]
    bwd = [e for e in ops if _args(e).get("Fwd thread id")]

    # each forward op's span, then each backward node's (by its forward)
    fwd_span = _innermost(fwd, ranges, [])
    by_seq = {}
    for e, name in zip(fwd, fwd_span):
        by_seq.setdefault(_args(e)["Sequence number"], []).append(
            (e["ts"], name))
    for v in by_seq.values():
        v.sort(key=lambda tn: tn[0])

    def forward_span(node):
        cands = by_seq.get(_args(node)["Sequence number"], ())
        i = bisect.bisect_right([t for t, _ in cands], node["ts"]) - 1
        return cands[i][1] if i >= 0 else None

    owner = _innermost(launches, ranges, bwd, forward_span)
    out = {}
    for e, name in zip(launches, owner):
        if name is not None:
            out[name] = out.get(name, 0.0) + dev.pop(_corr(e), 0.0)
    return out


def _thread(e):
    return str(e.get("pid")), str(e.get("tid"))


def span_seconds(rec, kind, name):
    """Device seconds attributed to the span ``name`` in the traced
    window (the driver's ``regions``), or None where it has none."""
    if rec.get("kind") != kind:
        return None
    return (rec.get("regions") or {}).get(name) or None


def span_share(rec, kind, name):
    """The span's device time over all device time in the window."""
    t = span_seconds(rec, kind, name)
    s = rec.get("summary") or {}
    if t is None or not s.get("device_s"):
        return None
    return t / s["device_s"]


def span_us_per_count(rec, kind, name, counter):
    """The span's device us over the window's count of ``counter``."""
    t = span_seconds(rec, kind, name)
    n = (rec.get("counters") or {}).get(counter)
    if t is None or not n:
        return None
    return 1e6 * t / n


def _innermost(points, ranges, nodes, node_span=None):
    """For each event of ``points`` (by its start), the name of the
    innermost enclosing range of its thread, or of the innermost
    enclosing backward node's forward span (``node_span``) where that
    node is closer; None where neither encloses it."""
    timeline = []
    for kind, evs in (("range", ranges), ("node", nodes)):
        for e in evs:
            timeline.append((_thread(e), e["ts"], 0, -e["dur"], kind, e))
    for i, e in enumerate(points):
        timeline.append((_thread(e), e["ts"], 1, 0, "point", i))
    timeline.sort(key=lambda r: r[:4])
    out = [None] * len(points)
    stack, thread = [], None
    for th, ts, _, _, kind, e in timeline:
        if th != thread:
            stack, thread = [], th
        while stack and stack[-1][0] < ts:
            stack.pop()
        if kind != "point":
            stack.append((ts + e["dur"], kind, e))
            continue
        for end, k, r in reversed(stack):
            if k == "range":
                out[e] = r["name"]
                break
            name = node_span(r) if node_span else None
            if name is not None:
                out[e] = name
                break
    return out
