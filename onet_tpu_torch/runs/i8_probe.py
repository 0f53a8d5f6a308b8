"""Cold-L2 timing of the int8 convolution kernels (``csrc/conv_i8.cu``) at
every site of the int8 serving graph (base 64, 512x512, batch 8), on one
card, beside the library call each stands beside, and the int8 serving
and train steps beside bf16's.

It times the kernels of whichever ``onet_tpu_torch`` it imports, so two
trees of the package compare on one card, one process each: run this file
with ``PYTHONPATH`` set to the tree whose kernels are timed::

    PYTHONPATH=. python onet_tpu_torch/runs/i8_probe.py
    PYTHONPATH=path/to/other/tree python onet_tpu_torch/runs/i8_probe.py

Each site runs in the out mode the graph gives it (``head_bf16=False``:
every site int8). down1-3.conv2 feed a skip and the next conv: a tree
with the two-code mode runs them in it (one launch, two code tensors);
a tree without runs them in f32, and ``requant_ms`` times the two eager
requantizations that then follow.

Every kernel call is timed on operands laid out beforehand, with the L2
cache flushed before it, outside the CUDA events (median of
``dw_probe.REPS``), and by the profiler's device time. Library: cuDNN's
bf16 conv at the 3x3 sites (a different function: no PyTorch call
computes an int8 3x3 conv), ``torch._int_mm`` on the transposed conv's
GEMM without the scatter. Bound: max(operations / 1979 TOP/s, bytes /
3.35 TB/s), each input read once and each output written once. Steps
(``--steps``): ``onet_infer_q`` at batch 8 and 32 (both head forms) and
bf16 ``onet_infer``, the ``quantized="fwd+dx"`` and exact train steps at
batch 8, on seeded random weights; CUDA events, median of 5 after 2
warm-ups. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

import torch
import torch.nn.functional as F

from onet_tpu_torch.runs.dw_probe import (PEAK_BYTES_S, card_line, cold_ms,
                                          device_ms)

PEAK_INT8_OPS_S = 1979e12     # H100 SXM dense int8 tensor cores
# site: (transposed, x [n, h, w, ci], co, out mode); modes as the graph
# runs them with head_bf16=False ("x2": the two consumers' codes)
SITES = {
    "inc.conv1": (False, (8, 512, 512, 2), 128, "unsigned"),
    "inc.conv2": (False, (8, 512, 512, 128), 128, None),
    "down1.conv1": (False, (8, 256, 256, 128), 256, "unsigned"),
    "down1.conv2": (False, (16, 256, 256, 128), 128, "x2"),
    "down2.conv1": (False, (16, 128, 128, 128), 256, "unsigned"),
    "down2.conv2": (False, (16, 128, 128, 256), 256, "x2"),
    "down3.conv1": (False, (16, 64, 64, 256), 512, "unsigned"),
    "down3.conv2": (False, (16, 64, 64, 512), 512, "x2"),
    "down4.conv1": (False, (16, 32, 32, 512), 1024, "unsigned"),
    "down4.conv2": (False, (16, 32, 32, 1024), 1024, "unsigned"),
    "up1.up": (True, (16, 32, 32, 1024), 512, "signed"),
    "up1.conv1": (False, (16, 64, 64, 1024), 512, "unsigned"),
    "up1.conv2": (False, (16, 64, 64, 512), 512, "unsigned"),
    "up2.up": (True, (16, 64, 64, 512), 256, "signed"),
    "up2.conv1": (False, (16, 128, 128, 512), 256, "unsigned"),
    "up2.conv2": (False, (16, 128, 128, 256), 256, "unsigned"),
    "up3.up": (True, (16, 128, 128, 256), 128, "signed"),
    "up3.conv1": (False, (16, 256, 256, 256), 128, "unsigned"),
    "up3.conv2": (False, (16, 256, 256, 128), 128, None),
    "up4.up": (True, (8, 256, 256, 256), 128, "signed"),
    "up4.conv1": (False, (8, 512, 512, 256), 128, "unsigned"),
    "up4.conv2": (False, (8, 512, 512, 128), 128, None),
}


def bound(convt, xs, co, nout: int, es: int) -> tuple:
    """(ms, 'bytes' | 'operations') of one launch: x and w read once,
    ``nout`` outputs of ``es`` bytes an element written once."""
    n, h, w, ci = xs
    cols = co * (4 if convt else 1)
    ops = 2 * n * h * w * cols * ci * (1 if convt else 9)
    kk = 4 if convt else 9
    nbytes = (n * h * w * ci + kk * ci * co + 3 * 4 * co
              + nout * es * n * h * w * cols)
    t_ops, t_bytes = ops / PEAK_INT8_OPS_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def site_call(CI, convt, x, w, scale, bias, s_next, requant):
    """(the kernel on operands laid out beforehand, its out mode)."""
    co = w.shape[3]
    two = requant == "x2" and hasattr(CI, "OUT_U8X2")
    if requant == "x2":
        requant = ("unsigned", "unsigned") if two else None
        s_next = (s_next, s_next * 0.5) if two else None
    mode = CI.out_mode(scale, requant)
    ops = CI.operands(x, w, convt)
    if len(ops) == 5:     # a tree whose kernel takes (x, B, vec, kpad)
        xk, b, _, kpad, vec = ops
        return (lambda: CI.kernel(xk, b, vec, kpad, co, scale, bias, s_next,
                                  mode, convt)), mode
    xk, b, p = ops
    return (lambda: CI.kernel(xk, b, p, co, scale, bias, s_next, mode,
                              convt)), mode


def time_site(CI, name, gen) -> dict:
    convt, xs, co, requant = SITES[name]
    dev = torch.device("cuda")
    kh = 2 if convt else 3
    x = torch.randint(0, 128, xs, generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (kh, kh, xs[3], co), generator=gen,
                      device=dev, dtype=torch.int8)
    scale = (torch.rand(co, generator=gen, device=dev) + 0.5) * 1e-4
    bias = torch.randn(co, generator=gen, device=dev)
    s_next = torch.rand(co, generator=gen, device=dev) * 0.02 + 0.005
    run, mode = site_call(CI, convt, x, w, scale, bias, s_next, requant)
    nout = 2 if requant == "x2" and hasattr(CI, "OUT_U8X2") else 1
    es = 4 if mode in (CI.OUT_I32, CI.OUT_F32) else 1
    out = {"x": list(xs), "co": co, "mode": mode, "outputs": nout,
           "ms": cold_ms(run), "device_ms": device_ms(run, kernels=1)}
    out["bound_ms"], out["bound_by"] = bound(convt, xs, co, nout, es)
    if requant == "x2" and nout == 1:
        # the f32 output's two eager requantizations, as models/quant.py
        # runs them where the kernel has no two-code mode
        y = run()

        def requants():
            for s in (s_next, s_next * 0.5):
                torch.clamp(torch.round(y / s), 0.0, 127.0).to(torch.int8)

        out["requant_ms"] = cold_ms(requants)
    if convt:
        xm = x.reshape(-1, xs[3])
        bm = w.flip(0, 1).permute(2, 0, 1, 3).reshape(xs[3], -1).contiguous()
        lib = lambda: torch._int_mm(xm, bm)   # noqa: E731
    else:
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        lib = lambda: F.conv2d(xb, wb, padding=1)   # noqa: E731
    out["library_ms"] = cold_ms(lib)
    out["library_device_ms"] = device_ms(lib)
    return out


def step_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_steps(gen) -> dict:
    """The int8 serving step (batch 8 and 32, both head forms) beside the
    bf16 stacked one, and the fwd+dx int8 train step beside the exact one
    (batch 8), at 512^2 on seeded random base-64 weights."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.quant import (calibrate, onet_infer_q,
                                             quantize_folded)
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    params, state = O.onet_init(torch.Generator().manual_seed(1981), 1,
                                base=64, device=dev)
    frames = torch.rand((32, 512, 512, 1), generator=gen, device=dev)
    out = {}
    with torch.inference_mode():
        folded = fold_onet(params, state)
        q = quantize_folded(folded, calibrate(folded, frames[:8]))
        for b in (8, 32):
            xb = frames[:b]
            for hb in (True, False):
                key = f"b{b}_int8{'_bf16head' if hb else ''}_step_ms"
                out[key] = step_ms(lambda: onet_infer_q(q, xb, head_bf16=hb))
            out[f"b{b}_bf16_stacked_step_ms"] = step_ms(lambda: onet_infer(
                folded, xb, policy=BF16_COMPUTE, pair_pack=False))
            torch.cuda.empty_cache()
    del folded, q
    old = O.PAIR_PACK
    O.PAIR_PACK = False
    try:
        for level in (None, "fwd+dx"):
            step = make_train_step(policy=BF16_COMPUTE, quantized=level)
            p, s, o = params, state, adam_init(params)

            def one():
                nonlocal p, s, o
                p, s, o, _ = step(p, s, o, frames[:8], 1e-5)

            out[f"train_{level or 'exact'}_step_ms"] = step_ms(one)
            torch.cuda.empty_cache()
    finally:
        O.PAIR_PACK = old
    return out


def main() -> None:
    from onet_tpu_torch.ops import conv_i8 as CI

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", action="store_true",
                    help="also time the serving and train steps")
    args = ap.parse_args()
    gen = torch.Generator(torch.device("cuda")).manual_seed(1981)
    out = {"tree": os.path.dirname(os.path.dirname(
               os.path.abspath(CI.__file__))),
           "card": card_line(), "sites": {}}
    with torch.inference_mode():
        for name in SITES:
            out["sites"][name] = time_site(CI, name, gen)
            torch.cuda.empty_cache()
    if args.steps:
        out["steps"] = time_steps(gen)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
