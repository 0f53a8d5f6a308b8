"""Probe: the BatchNorm-stats epilogue at the native stacked layout, on the
card (the port of ``runs/bd_epilogue_probe.py``).

At the three 512^2 stacked sites of the Onet forward

  inc.conv2   [8, 512, 512, 128] x bd2 [3, 3, 128, 128]
  up4.conv1   two-input concat(skip, up), each [8, 512, 512, 128]
  up4.conv2   [8, 512, 512, 128] x bd2 [3, 3, 128, 128]

it times the hand-written conv with its fused stats (``ops/conv_bd.py``)
against the library formulation (cuDNN conv, then a separate stats pass:
``conv_stats_library``), each chained into the same consumer (batch mean
and variance from s1/s2, normalize, a strided sum), as the train step's
BatchNorm would consume them; and cuDNN's conv alone at each site (inputs
concatenated beforehand). Times: CUDA events, median of ``REPS`` single
calls after a warm-up. Then the numerics cross-check of the kernel against
the library at full size.

    python -m onet_tpu_torch.runs.bd_epilogue_probe [--out FILE]

Prints the JSON; writes it only to ``--out``. Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.models.layers import bd2
from onet_tpu_torch.ops.conv_bd import (
    conv3x3_bd2in_raw, conv3x3_bd_raw, conv_stats_library)

B, H, W = 8, 512, 512
REPS = 5


def inputs(dev, *, b=B, h=H, w=W, seed=0):
    """Two bf16 activations 0.1 * N(0, 1) [b, h, w, 128] (drawn on the
    device from ``seed``) and three bd2 weights of seeded [3, 3, 64, 64]
    taps (numpy, x0.05, rounded to bf16)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x, xb = [(0.1 * torch.randn((b, h, w, 128), generator=g, device=dev))
             .to(torch.bfloat16) for _ in range(2)]
    rng = np.random.default_rng(seed)

    def mkw():
        taps = rng.normal(size=(3, 3, 64, 64)).astype(np.float32) * 0.05
        return bd2(torch.from_numpy(taps).to(dev, torch.bfloat16))

    return x, xb, mkw(), mkw(), mkw()


def consume(y, s1, s2):
    """Batch mean and variance from the lane sums, then a scalar that
    touches the normalized output (the train step's BatchNorm reads)."""
    npix = y.shape[0] * y.shape[1] * y.shape[2]
    mean = s1.sum(0) / npix
    var = s2.sum(0) / npix - mean.square()
    yn = (y.float() - mean) * torch.rsqrt(var + 1e-5)
    return yn[:, ::64, ::64, :].sum()


def site1(x, w):
    """inc.conv2 / up4.conv2 through the kernel."""
    return consume(*conv3x3_bd_raw(x, w, stats=True))


def site2(xa, xb, wa, wb):
    """up4.conv1 through the two-input kernel."""
    return consume(*conv3x3_bd2in_raw(xa, xb, wa, wb, stats=True))


def site1_library(x, w):
    return consume(*conv_stats_library(x, w))


def site2_library(xa, xb, wa, wb):
    return consume(*conv_stats_library(torch.cat([xa, xb], dim=-1),
                                       torch.cat([wa, wb], dim=2)))


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def conv_only_ms(xs, ws) -> float:
    """cuDNN's conv alone at a site: the inputs concatenated on the lanes and
    laid out for F.conv2d outside the timed call, no stats."""
    x = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
    w = torch.cat(ws, dim=2).permute(3, 2, 0, 1).contiguous()
    return cuda_ms(lambda: F.conv2d(x, w, padding=1))


def run(dev=None, *, seed: int = 0) -> dict:
    """The probe's measurements on the card, as a dict."""
    dev = resolve_device(dev)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the card; it has no CPU mode")
    x, xb, w1, wa, wb = inputs(dev, seed=seed)
    out = {"device": torch.cuda.get_device_name(dev),
           "shape": [B, H, W, 128], "reps": REPS, "sites": {}}
    out["sites"]["single_128"] = {
        "library_conv_plus_stats_ms": cuda_ms(lambda: site1_library(x, w1)),
        "kernel_ms": cuda_ms(lambda: site1(x, w1)),
        "library_conv_only_ms": conv_only_ms([x], [w1])}
    y_k, _, s2_k = conv3x3_bd_raw(x, w1, stats=True)
    y_r, _, s2_r = conv_stats_library(x, w1)
    out["sites"]["single_128"]["max_abs_y_diff"] = float(
        (y_k.float() - y_r.float()).abs().max())
    out["sites"]["single_128"]["rel_s2_diff"] = float(
        ((s2_k - s2_r).abs() / (s2_r.abs() + 1e-3)).max())
    del y_k, y_r
    out["sites"]["two_input_256"] = {
        "library_conv_plus_stats_ms": cuda_ms(
            lambda: site2_library(x, xb, wa, wb)),
        "kernel_ms": cuda_ms(lambda: site2(x, xb, wa, wb)),
        "library_conv_only_ms": conv_only_ms([x, xb], [wa, wb])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    res = run()
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
