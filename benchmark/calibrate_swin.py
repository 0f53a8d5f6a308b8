"""Readings that the Swin-Unet training cell's limits of ``correct`` are
set from, on the card at the cell's own size (``calibrate.py``'s method;
its code is the Onet's): the program's numbers over many seeds, and on
the first few seeds those of a control and of three faults, each a run of
the float32 reference (``reference/swin_unet.py``) in the program's
place, judged against the sound reference on the same seed:

* ``fp8``: every linear's and conv's operands rounded to float8 e4m3, the
  precision below the configuration's bf16;
* ``half_batch``: the loss taken over the first half of each batch;
* ``no_mask``: the shifted windows' seam mask left out;
* ``no_rpb``: the relative-position bias left out.

    python3 benchmark/calibrate_swin.py [--workload <cell>] --seeds 12
        [--fault-seeds 3] [--seconds 2] [--out file.jsonl]

Each line of the output is a JSON object {"cell", "seed", "side",
"checks"}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SIDES = ("fp8", "half_batch", "no_mask", "no_rpb")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="swinunet-t-bf16.train-224-b64")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4200000000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    from benchmark.calibrate import _ctx
    from benchmark.reference.onet import fp8_e4m3
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    dev = torch.device("cuda")
    bench = harness.load_benchmark(ROOT)
    out = open(args.out, "a") if args.out else sys.stdout

    def emit(seed, side, got, t0):
        line = {"cell": args.workload, "seed": seed, "side": side,
                "s": time.perf_counter() - t0, "checks": got}
        print(json.dumps(line), file=out, flush=True)
        harness.log(json.dumps(line))

    try:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            ctx = _ctx(harness, bench, args.workload, seed, args.seconds,
                       dev)
            drv = harness.driver(ctx.mix["driver"])
            t0 = time.perf_counter()
            st = drv.setup(ctx)
            drv.window(ctx, st)
            drv.free_program(st)
            ref, p0 = drv.reference_run(ctx, st)
            emit(seed, "program", drv.readings(st["first"], ref, p0), t0)
            for side in SIDES if i < args.fault_seeds else ():
                t0 = time.perf_counter()
                kw = ({"cast": fp8_e4m3} if side == "fp8"
                      else {"fault": (side,)})
                stand_in, _ = drv.reference_run(ctx, st, **kw)
                emit(seed, side, drv.readings(
                    drv.reference_first(stand_in, p0), ref, p0), t0)
                del stand_in
            del st, ref
            torch.cuda.empty_cache()
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
