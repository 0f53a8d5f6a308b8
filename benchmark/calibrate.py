"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size: the program's numbers over many seeds, the control's
over a few, and for a training cell the faults' (see PERF.md, "How
correct is decided").

    python3 benchmark/calibrate.py --workload <cell> --seeds 12
        [--control-seeds 3] [--seconds 2] [--out file.jsonl]

One process reads every seed (set-up is the cost). Each line of the
output is a JSON object {"cell", "seed", "side", "checks"}; ``side`` is
"program", "control", or a fault's name. The controls:

* bf16 training: the port's own int8 training path
  (``make_train_step(quantized="fwd+dx")``); the half-batch fault: the
  loss taken over the first half of each batch;
* bf16 serving: the reference with fp8 (e4m3) conv operands in the
  program's place, on the frames a run's check compares, judged against
  the float32 reference;
* int8 serving: the reference at int4 (``reference/quant.py``, qmax 7)
  in the program's place, judged against the int8 reference.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _ctx(harness, bench, cell, seed, seconds, device):
    wl, ce = harness.find_cell(bench, cell)
    return harness.Context(cell=cell, cfg=harness.load_config(ce, ROOT),
                           mix=harness.load_mix(wl["traffic"]), seed=seed,
                           seconds=seconds, trace=False, device=device,
                           tmpdir=os.environ.get("TMPDIR", "/tmp"))


def program_checks(harness, ctx):
    drv = harness.driver(ctx.mix["driver"])
    st = drv.setup(ctx)
    rec = drv.window(ctx, st)
    return drv.check(ctx, st, rec)


def train_side(harness, ctx, side):
    """A training cell's checks with the port's int8 training or the
    half-batch fault in the program's place."""
    import onet_tpu_torch.train.steps as S
    from onet_tpu_torch.models.onet import OnetOutput, compute_loss

    saved = (S.make_train_step, dict(S.LOSSES))
    try:
        if side == "control":
            S.make_train_step = functools.partial(saved[0],
                                                  quantized="fwd+dx")
        elif side == "half_batch":
            def half(out):
                n = out.S.shape[0] // 2
                return compute_loss(OnetOutput(*(
                    None if t is None else t[:n] for t in out)))
            S.LOSSES["jsd"] = half
        return program_checks(harness, ctx)
    finally:
        S.make_train_step = saved[0]
        S.LOSSES.clear()
        S.LOSSES.update(saved[1])


def fp8_control(harness, ctx):
    """bf16 serving's control: the reference with fp8 (e4m3) conv
    operands in the program's place, on the frames a run samples, judged
    against the float32 reference."""
    import torch
    from benchmark.drivers import serve
    from benchmark.inputs import onet_weights
    from benchmark.reference.onet import eval_logits, fp8_e4m3, label_gap
    from benchmark.traffic import frames

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    pool = frames.make_pool(ctx.seed, mix["pool"], cfg["input_hw"],
                            psnr=mix["psnr_db"], device=dev)
    if mix["driver"] == "requests":
        from benchmark.drivers import requests
        idx = requests.checked_frames(ctx)
    else:
        sample = serve.Reservoir(mix["check_frames"], ctx.seed)
        for k in range(pool.shape[0]):
            sample.offer(k, lambda: None)
        idx = [k for k, _ in sample.items]
    x = pool[idx]
    params, state = onet_weights.make(ctx.seed, cfg["in_channels"],
                                      cfg["base"], dev)
    vt8, vd8 = eval_logits(params, state, x, cast=fp8_e4m3)
    labels = (vd8 > vt8).to(torch.uint8).cpu()
    vt, vd = eval_logits(params, state, x)
    lim = cfg["limits"]["serve"]
    return {k: (v, lim.get(k)) for k, v in label_gap(vt, vd, labels).items()}


def int8_control(harness, ctx):
    """int8 serving's control: the int4 reference's labels on the frames
    a run samples, judged against the int8 reference."""
    import torch
    from benchmark.drivers import serve
    from benchmark.reference import quant
    from benchmark.reference.onet import label_gap
    from benchmark.inputs import onet_weights
    from benchmark.traffic import frames

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    pool = frames.make_pool(ctx.seed, mix["pool"], cfg["input_hw"],
                            psnr=mix["psnr_db"], device=dev)
    sample = serve.Reservoir(mix["check_frames"], ctx.seed)
    for k in range(pool.shape[0]):
        sample.offer(k, lambda: None)
    idx = [k for k, _ in sample.items]
    params, state = onet_weights.make(ctx.seed, cfg["in_channels"],
                                      cfg["base"], dev)
    fp = quant.fold(params, state)
    scales = quant.calibrate(fp, pool[:cfg["calibration_frames"]])
    x = pool[idx]
    vt4, vd4 = quant.quant_logits(fp, scales, x, qmax=7.0)
    labels = (vd4 > vt4).to(torch.uint8).cpu()
    vt, vd = quant.quant_logits(fp, scales, x, qmax=cfg["qmax"])
    lim = cfg["limits"]["serve"]
    return {k: (v, lim.get(k)) for k, v in label_gap(vt, vd, labels).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4100000000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sides", default="program,control")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    dev = torch.device("cuda")
    bench = harness.load_benchmark(ROOT)
    out = open(args.out, "a") if args.out else sys.stdout
    sides = args.sides.split(",")
    try:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            for side in sides:
                if side != "program" and i >= args.control_seeds:
                    continue
                ctx = _ctx(harness, bench, args.workload, seed,
                           args.seconds, dev)
                t0 = time.perf_counter()
                drv = ctx.mix["driver"]
                if side == "program":
                    got = program_checks(harness, ctx)
                elif drv == "train":
                    got = train_side(harness, ctx, side)
                elif ctx.cfg["precision"] == "int8":
                    got = int8_control(harness, ctx)
                else:
                    got = fp8_control(harness, ctx)
                line = {"cell": args.workload, "seed": seed, "side": side,
                        "s": time.perf_counter() - t0,
                        "checks": {k: v for k, (v, _) in got.items()}}
                print(json.dumps(line), file=out, flush=True)
                harness.log(json.dumps(line))
                torch.cuda.empty_cache()
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
