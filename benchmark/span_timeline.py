"""Where a served batch's idle device time falls among the program's own
spans. Reads a directory that ``onet_tpu_torch/runs/span_probe.py``
wrote: its Chrome trace (``trace.json``) and the traced calls' span
records laid on the trace's ``ts`` axis (``span_probe.json``). Each idle
gap between device records is named as ``trace.py`` names it in a cell's
``breakdown`` (the outermost host op running at its start), and its time
is shared among the innermost spans that cover it.

    python -m benchmark.span_timeline runs/span_probe

Prints one JSON line a call: each span's start (ms after the call's
first) and length, and the call's idle ms by (span, gap name).
"""

from __future__ import annotations

import json
import os
import sys

from benchmark.trace import DEVICE_CATS, _host_at, _outermost, _union


def place_gaps(events, rows):
    """{(span, gap name): idle ms} over the calls' time: each part of a
    gap goes to the innermost span covering it (None where none does)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and "dur" in e]
    cpu = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and "dur" in e]
    outer = _outermost(cpu)
    starts = [e["ts"] for e in outer]
    lo, hi = rows[0]["ts_us"], max(r["end_us"] for r in rows)
    edges = sorted({r[k] for r in rows for k in ("ts_us", "end_us")})
    # the calls' ends bound the first and the last gap
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev]
                    + [(lo, lo), (hi, hi)])
    out = {}
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        a, b = max(a1, lo), min(b0, hi)
        if b <= a:
            continue
        gap = _host_at(outer, starts, a)
        cuts = [a] + [t for t in edges if a < t < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            cover = [r for r in rows if r["ts_us"] <= x < r["end_us"]]
            inner = min(cover, key=lambda r: r["end_us"] - r["ts_us"],
                        default=None)
            key = (inner and inner["name"], gap)
            out[key] = out.get(key, 0.0) + (y - x) / 1e3
    return out


def main(argv=None) -> None:
    d = (argv or sys.argv[1:])[0]
    with open(os.path.join(d, "span_probe.json")) as f:
        calls = json.load(f)["serving"]["calls"]
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    for rows in calls:
        t0 = rows[0]["ts_us"]
        idle = place_gaps(events, rows)
        print(json.dumps({
            "spans": [[r["name"], round((r["ts_us"] - t0) / 1e3, 3),
                       r["ms"]] for r in rows],
            "idle_ms": [[s, g, round(ms, 3)] for (s, g), ms in
                        sorted(idle.items(), key=lambda kv: -kv[1])]}),
            flush=True)


if __name__ == "__main__":
    main()
