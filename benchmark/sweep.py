"""Find the highest request rate the session sustains: one process, one
warm session, the request driver's window at each rate in turn.

    python3 benchmark/sweep.py --workload <request cell> --rates 10,20,30
        [--seconds 10] [--seed n]

Prints one JSON line a rate: offered and completed requests a second,
p50 and p95 latency, failures, and whether the queue drained within the
window (the last request's latency against the median's). Run once, when
a request cell is defined; the cell's mix then fixes its rate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=4300000000)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    bench = harness.load_benchmark(ROOT)
    wl, ce = harness.find_cell(bench, args.workload)
    mix = harness.load_mix(wl["traffic"])
    ctx = harness.Context(cell=args.workload,
                          cfg=harness.load_config(ce, ROOT), mix=mix,
                          seed=args.seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda"),
                          tmpdir=os.environ.get("TMPDIR", "/tmp"))
    drv = harness.driver(mix["driver"])
    st = drv.setup(ctx)
    for rate in [float(r) for r in args.rates.split(",")]:
        ctx.mix = dict(mix, rate_per_s=rate)
        t0 = time.perf_counter()
        rec = drv.window(ctx, st)
        wall = time.perf_counter() - t0
        lat = np.asarray(rec["latency_s"]) * 1e3
        half = len(lat) // 2
        print(json.dumps({
            "rate": rate, "due": rec["attempted"], "failed": rec["failed"],
            "p50_ms": float(np.median(lat)),
            "p95_ms": rec["e2e"]["request_p95_ms"],
            "max_ms": float(lat.max()),
            # a growing queue: the second half waits longer than the first
            "p50_first_half_ms": float(np.median(lat[:half])),
            "p50_second_half_ms": float(np.median(lat[half:])),
            "drain_s": wall - args.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
