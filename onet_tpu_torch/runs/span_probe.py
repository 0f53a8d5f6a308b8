"""The span recorder (``utils/profiling.py``) on one card: what a span
costs with the profiler off and on, and whether its records map onto the
profiler's Chrome trace (``trace_us``).

    python -m onet_tpu_torch.runs.span_probe [--out runs/span_probe]

* Cost: a loop of ``--spans`` empty spans, ns a span, with no profiler;
  under a ``torch.profiler`` session (CPU and CUDA activities) on the
  thread that started it, where each span is also a ``record_function``
  range; and on another thread, which that session does not record.
* Serving: a ``ServingSession`` at the bf16 serve cell's shape (base 64,
  one channel, ``BF16_COMPUTE``, batch 32 of 512^2 host frames, random
  weights), warmed, then ``--batches`` calls traced by
  ``utils/profiling.trace``. For each call after the first, every span's
  record on the trace's ``ts`` axis and its distance from its
  ``user_annotation`` range (the larger of the starts' and the ends'
  distances, us); and the session's counters (``steps``,
  ``labels_staged``, ``staging_allocs``) after the calls.

Needs a card: without one it exits. Prints one JSON line and writes it,
with the traced calls' spans, to ``--out``/span_probe.json, beside the
Chrome trace (``trace.json``); ``python -m benchmark.span_timeline OUT``
then places the device's idle gaps among the spans.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from onet_tpu_torch.utils import profiling as P


def ns_per_span(n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        with P.span("probe"):
            pass
    return (time.perf_counter_ns() - t) / n


def cost(n: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    ns_per_span(1000)
    out = {"off_ns": ns_per_span(n)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_ns"] = ns_per_span(n)
        box = []
        th = threading.Thread(target=lambda: box.append(ns_per_span(n)))
        th.start()
        th.join()
        out["on_other_thread_ns"] = box[0]
    out["off_again_ns"] = ns_per_span(n)
    return out


def serving(batches: int, logdir: str) -> dict:
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.serve.http import ServingSession

    device = torch.device("cuda")
    base, hw, batch = 64, 512, 32
    params, state = onet_init(torch.Generator().manual_seed(21), 1,
                              base=base, device=device)
    with torch.no_grad():
        folded = fold_onet(params, state)
    sess = ServingSession(
        lambda f, x: onet_infer(f, x, policy=BF16_COMPUTE), folded,
        batch=batch, in_channels=1, mode="bf16", input_hw=(hw, hw),
        device=device)
    frames = np.random.default_rng(21).uniform(
        0, 1, (2 * batch, hw, hw, 1)).astype(np.float32)
    sess.warmup()
    sess.segment(frames[:batch])
    marks = []
    with P.trace(logdir):
        for k in range(batches):
            marks.append(P.mark())
            sess.segment(frames[(k % 2) * batch:(k % 2 + 1) * batch])
    with open(os.path.join(logdir, P.TRACE_FILE)) as f:
        data = json.load(f)
    base_ns = data["baseTimeNanoseconds"]
    ranges = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    recs = P.profiled_spans()
    pair = {}
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start)
        theirs = sorted(ranges.get(name, []), key=lambda e: e["ts"])
        for r, e in zip(mine, theirs):
            pair[r.id] = e
    calls = []
    for lo, hi in zip(marks[1:], marks[2:] + [float("inf")]):
        rows = []
        for r in sorted((r for r in recs if lo < r.id < hi),
                        key=lambda r: r.start):
            a, b = P.trace_us(r.start, base_ns), P.trace_us(r.end, base_ns)
            e = pair.get(r.id)
            rows.append({"name": r.name, "ts_us": a, "end_us": b,
                         "ms": round(r.ms, 3),
                         "range_gap_us": None if e is None else round(max(
                             abs(a - e["ts"]),
                             abs(b - e["ts"] - e["dur"])), 1)})
        calls.append(rows)
    gaps = [r["range_gap_us"] for c in calls for r in c]
    c = P.counters()
    return {"shape": [batch, hw, hw, 1], "base": base, "calls": calls,
            "counters": {k: c.get(k, 0) for k in (
                "steps", "labels_staged", "staging_allocs")},
            "ranges_found": all(g is not None for g in gaps),
            "max_range_gap_us": max(g for g in gaps if g is not None),
            "trace_base_ns": base_ns}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("runs", "span_probe"))
    ap.add_argument("--spans", type=int, default=100_000)
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_probe: no CUDA device; it measures the card "
                         "and has no CPU mode")
    from onet_tpu_torch.runs.dw_probe import card_line

    out = {"card": card_line(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "cost": cost(args.spans),
           "serving": serving(args.batches, args.out)}
    with open(os.path.join(args.out, "span_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    summary = dict(out)
    summary["serving"] = {k: v for k, v in out["serving"].items()
                          if k != "calls"}
    t0 = out["serving"]["calls"][0][0]["ts_us"]
    summary["serving"]["first_call"] = [
        {"name": r["name"], "start_ms": round((r["ts_us"] - t0) / 1e3, 3),
         "ms": r["ms"], "range_gap_us": r["range_gap_us"]}
        for r in out["serving"]["calls"][0]]
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
