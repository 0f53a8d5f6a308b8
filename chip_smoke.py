#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (onet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit; build the CUDA kernels from csrc/, print
     ptxas's registers and spills of the conv kernels (fatal if the bf16
     ones spill).
  2. kernels: each hand-written kernel against its plain PyTorch version at
     N=4, 512x512 (bf16 and f32): the conv with bias+ReLU on and off, the
     conv with the BatchNorm-stats epilogue (one and two inputs), the weight
     gradient; bf16 at a ragged 520x516 (the width not a multiple of the
     kernels' 64-pixel strip): the stats and serving epilogues (one and two
     inputs) and the weight gradient, each twice, bit-identical; and at
     the shapes the main paths give them, bf16: the
     serving epilogue at the HTTP batch (8 frames -> N=16 packed samples),
     the stats epilogue, the input-gradient conv and the weight gradient at
     the training batch (8 -> N=16). Then timed beside its plain version, a
     one-call library yardstick and its bound, each compared again on the
     inputs it is timed on: the serving epilogue at the serving shape of
     bench.py (batch 32 -> N=64), the stats epilogue, the input-gradient
     conv and the weight gradient at the training shape; the kernels and
     their cuDNN yardsticks with the L2 cache flushed before each call,
     beside the profiler's device time (the conv rows also keep their
     earlier warm timing).
  3. serving: the weight-shared Onet at full width (base 64, seeded random
     weights and BN statistics), BN-folded, behind the HTTP daemon on
     localhost, bf16, pair-packed path; 3 POST /segment requests of
     8 frames at 512^2, checked against direct calls, the stacked path and
     fp32; launch counts read around those requests; throughput.
  4. training: the same Onet (seeded random weights), bf16, batch 8,
     512^2, pair-packed path: 3 steps of make_train_step with Adam at
     lr 1e-5, launch counts read around them; against the stacked step
     (cuDNN only) from the same start, in fp32 at batch 2 (loss, gradient
     cosine) and bf16 at batch 8 (loss); step time and frames/s for both
     paths, a profiler breakdown and the peak memory of a pair-packed step;
     one make_eval_step call on labels thresholded from the frames.
  5. the other kernels (JSD head forward and backward, min-max,
     native-layout conv with stats, one and two inputs): each against its
     plain version at small shapes (f32, bf16, ragged; bd also at a ragged
     (3, 131, 260) twice, stats bit-identical); then the main path,
     launches counted: fused_jsd_loss forward and backward on the four
     [8,512,512,64] bf16 halves of one full-width training forward,
     paired_input on the train batch's frames, the bd probe's two
     N=8 512x512 sites through the probe module; those outputs against the
     plain versions, compute_loss and autograd of the stacked head; timings
     beside the plain version, the bound and cuDNN's conv alone (bd: both
     with the L2 flushed, by the profiler's device time and warm, as in
     phase 2) or the eager formulation; the probe's own warm A/B.
  6. the simclutter workload (``simclutter_workload``): both clutter
     families generated on the card, three epochs of train() at full
     width (base 64, 224^2, batch 10, bf16, pair-packed) with the
     pair-packed kernels' launches counted, a resume; every kernel launch
     of one step at the driver's full batch (N=20 packed) and at its
     ragged batch (N=10) against its plain version on the step's own
     operands, and the step's loss against the stacked step's; epoch and
     step times and the driver's host share.
The second-to-last line is the kernels JSON, the last the result JSON.
Exits non-zero without a CUDA device or without the port beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from onet_tpu_torch.runs.bd_epilogue_probe import cuda_ms
from onet_tpu_torch.runs.dw_probe import (SPIN_CYCLES, cold_ms, device_ms,
                                          queued_ms)

SEED = 1981
H = W = 512
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM float32 outside the tensor cores
HBM = 3.35e12           # H100 SXM HBM3 bytes/s
# s1, s2 and dw against their plain versions, relative to their largest
# magnitude, f32 and bf16 inputs alike: both sum exact f32 products (bf16
# products are exact in f32) in another order, the [check] lines print by
# how much. One tile dropped or counted twice moves them by far more: a
# 4x32-pixel dw tile of the N=16 training batch by 3.1e-5 of dw, an
# 8x32-pixel conv tile by 9.8e-4 of its sample's s1/s2 at 512x512.
SUM_REL = 1e-5
KERNELS = {
    "conv3x3_wp": dict(nin=1, replaces="onet_tpu/ops/pallas_conv.py:212"),
    "conv3x3_wp2": dict(nin=2, replaces="onet_tpu/ops/pallas_conv.py:259"),
}
N_TRAIN = 16            # packed samples of bench.py's train batch of 8
TRAIN_STEPS = 3
LR = 1e-5               # bench.py's learning rate
# launches per pair-packed train step: 2 forward + 4 dx, 1, 4 dw
PER_STEP = {"conv3x3_wp": 6, "conv3x3_wp2": 1, "conv3x3_wp_dw": 4}


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def bound(nin: int, n: int, dtype, *, stats=False, dw=False) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time for the useful work of
    one call, inputs read once and outputs written once, 9 taps of 64x64
    per input. Conv: x (nin), taps and bias in, y (and s1, s2) out. Weight
    gradient: x and dy in, dw [3, 3, 64, 64] f32 out."""
    size = torch.tensor([], dtype=dtype).element_size()
    act = n * H * W * 64 * size
    if dw:
        nbytes = 2 * act + 9 * 64 * 64 * 4
    else:
        nbytes = (nin * act + act + nin * 9 * 64 * 64 * size + 128 * 4
                  + stats * 2 * n * 128 * 4)
    flops = 2 * n * H * W * 64 * 64 * 9 * nin
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def breakdown(fn, label: str, top: int = 10, kernels: int | None = None,
              tries: int = 3, host: bool = True):
    """Device time by kernel over one call, from torch.profiler; the wall
    time includes the profiler's own cost. Short spin kernels before and
    after the call (left out of the sums) keep its records off both ends
    of the trace. With ``kernels``, the launches one call makes, a profile
    that missed some is taken again, up to ``tries`` times; the log line
    says if it stays short. ``host=False`` traces the card's activity
    only."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(SPIN_CYCLES // 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(SPIN_CYCLES // 10)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key]
        count = sum(e.count for e in kern)
        if kernels is None or count == kernels:
            break
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    short = ("" if kernels is None or count == kernels else
             f" (INCOMPLETE: {count} of the call's {kernels} launches "
             f"recorded in {tries} tries)")
    log(f"[profile] {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"in {count} kernels, idle share {1 - busy / wall:.3f}{short}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<3d} {e.key[:100]}")


def timed(fn, prefix: str = "", kernels: int | None = None) -> dict:
    """{ms, device_ms, queued_ms, warm_ms} of one call: CUDA events with
    the L2 cache flushed before each call (as a train step or a served
    batch finds it); the profiler's device time, the sum of the call's
    kernels (no host work counts; ``kernels``, where given, the launches
    one call makes, each of which the profiler must have recorded, else
    None); CUDA events with the L2 flushed and the card held behind a spin
    kernel, from the call's first kernel's start to its last one's end (no
    host work, the card's gaps between kernels included); and CUDA events
    on a warm cache (the timing of earlier runs, kept for history)."""
    return {prefix + "ms": cold_ms(fn),
            prefix + "device_ms": device_ms(fn, kernels=kernels),
            prefix + "queued_ms": queued_ms(fn),
            prefix + "warm_ms": cuda_ms(fn)}


def fmt_ms(v, digits: int = 3) -> str:
    """A time for the log; None where the profiler missed a record."""
    return "not recorded" if v is None else f"{v:.{digits}f}"


# matched in order against each mangled name, which holds its source's
# file name: "conv_bd" comes after the other kernels of conv_bd.cu
KERNEL_NAMES = ("conv_wp_bf16_1in", "conv_wp_bf16_2in", "conv_wp_f32",
                "stats_reduce_ranges", "stats_reduce", "dw_bf16", "dw_f32",
                "dw_reduce", "conv_bd", "head_fwd_reduce", "head_fwd",
                "head_bwd", "minmax_cluster")


def ptxas_report(_build, source: str, no_spill: str = "") -> None:
    """Log ptxas's registers and spills of each kernel of csrc/<source>.cu
    (from nvcc -Xptxas -v); raise if a kernel whose name holds
    ``no_spill`` spills."""
    entry = "?"
    for line in _build.LOGS.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = next((k for k in KERNEL_NAMES if k in m.group(1)),
                         m.group(1))
        elif "registers" in line or "spill" in line or "C75" in line:
            log(f"[build] {source} ptxas {entry}: {line.strip()}")
            if no_spill and no_spill in entry and re.search(
                    r"[1-9]\d* bytes spill", line):
                raise AssertionError(f"{entry} spills registers: {line}")


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def kernel_inputs(TC, n, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((n, H, W // 2, 128), generator=g, dtype=dtype)
          .clamp_min(0).to(dev) for _ in range(2)]
    w64 = [0.06 * torch.randn((3, 3, 64, 64), generator=g) for _ in range(2)]
    ws = [tuple(t.to(dev) for t in TC.make_wc_we(w, dtype=dtype))
          for w in w64]
    bias = (0.1 * torch.randn(64, generator=g)).repeat(2).to(dev)
    return xs, ws, w64, bias


def call(TC, name, xs, ws, bias, plain=False, **kw):
    if name == "conv3x3_wp":
        fn = TC.conv3x3_wp_plain if plain else TC.conv3x3_wp_raw
        return fn(xs[0], *ws[0], bias=bias, **kw)
    fn = TC.conv3x3_wp2_plain if plain else TC.conv3x3_wp2_raw
    return fn(xs[0], xs[1], *ws[0], *ws[1], bias=bias, **kw)


def conv_err(TC, name, xs, ws, bias, tag, **kw) -> float:
    """One conv kernel against its plain version on the same inputs; raises
    on disagreement. y: f32 rtol/atol 1e-4 with TF32 off; bf16 inputs
    against the plain f32 accumulator, |err| <= 2e-2 * max|y| (one bf16
    rounding of the output). s1, s2 (stats=True): SUM_REL of their largest
    magnitude. Returns the largest absolute error of the outputs."""
    dtype = xs[0].dtype
    got = call(TC, name, xs, ws, bias, **kw)
    ref = call(TC, name, xs, ws, bias, plain=True, out_dtype=torch.float32,
               **kw)
    torch.cuda.synchronize()
    if not kw.get("stats"):
        got, ref = (got,), (ref,)
    y, ry = got[0], ref[0]
    if y.dtype != dtype or y.shape != ry.shape:
        raise AssertionError(f"{tag}: y {y.dtype} {tuple(y.shape)}")
    errs = [(y.float() - ry).abs().max().item()]
    scale = ry.abs().max().item()
    ok = (torch.allclose(y, ry, rtol=1e-4, atol=1e-4)
          if dtype == torch.float32 else errs[0] <= 2e-2 * scale)
    msg = [f"y {errs[0]:.3e} (max {scale:.3e})"]
    for label, s, r in zip(("s1", "s2"), got[1:], ref[1:]):
        err, top = (s - r).abs().max().item(), r.abs().max().item()
        ok = ok and err <= SUM_REL * top
        errs.append(err)
        msg.append(f"{label} {err:.3e} (max {top:.3e})")
    log(f"[check] {tag}: {', '.join(msg)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with its plain version")
    return max(errs)


def dw_err(TC, x, dy, tag) -> float:
    """conv3x3_wp_dw against its plain version: SUM_REL of max|dw|."""
    dw = TC.conv3x3_wp_dw(x, dy)
    ref = TC.conv3x3_wp_dw_plain(x, dy)
    torch.cuda.synchronize()
    err, top = (dw - ref).abs().max().item(), ref.abs().max().item()
    ok = err <= SUM_REL * top
    log(f"[check] {tag}: max_abs_err={err:.3e} max|dw|={top:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with its plain version")
    return err


def check_kernels(TC, dev) -> dict:
    """The serving epilogue (bias+ReLU on and off) at N=4 in f32 and bf16,
    and at the HTTP batch of the serving phase (8 frames -> N=16 packed) in
    bf16; the errors reported are those of the HTTP shape with bias+ReLU."""
    errs = {}
    for n, dtype in ((4, torch.float32), (4, torch.bfloat16),
                     (N_TRAIN, torch.bfloat16)):
        xs, ws, _, bias = kernel_inputs(TC, n, dtype, dev, seed=SEED + n)
        for name in KERNELS:
            for relu in (False, True):
                err = conv_err(TC, name, xs, ws, bias,
                               f"{name} N={n} {str(dtype)[6:]} "
                               f"bias_relu={relu}", bias_relu=relu)
                if n == N_TRAIN and relu:
                    errs[name] = err
        del xs
        torch.cuda.empty_cache()
    return errs


def check_train_kernels(TC, dev):
    """The stats epilogue (nin 1 and 2, no bias/ReLU, as training runs it)
    and dw at N=4, 512x512, in f32 and bf16; dw in bf16 at a ragged shape
    (520x516: the width is not a multiple of the kernel's 64-pixel strip)
    and twice on the same inputs (bit-identical). The training shape (N=16,
    bf16) is compared where it is timed, in time_train_kernels."""
    for dtype in (torch.float32, torch.bfloat16):
        xs, ws, _, _ = kernel_inputs(TC, 4, dtype, dev, seed=SEED + 2)
        for name in KERNELS:
            conv_err(TC, name, xs, ws, None,
                     f"{name}+stats N=4 {str(dtype)[6:]}", stats=True)
        dw_err(TC, xs[0], xs[1], f"conv3x3_wp_dw N=4 {str(dtype)[6:]}")
    g = torch.Generator().manual_seed(SEED + 4)
    x, dy = [torch.randn((3, 520, 258, 128), generator=g,
                         dtype=torch.bfloat16).to(dev) for _ in range(2)]
    dw_err(TC, x, dy, "conv3x3_wp_dw (3, 520, 516) bf16")
    if not torch.equal(TC.conv3x3_wp_dw(x, dy), TC.conv3x3_wp_dw(x, dy)):
        raise AssertionError("conv3x3_wp_dw differs between two calls")
    log("[check] conv3x3_wp_dw (3, 520, 516) bf16: two calls bit-identical")
    ws = [tuple(t.to(dev) for t in TC.make_wc_we(
        0.06 * torch.randn((3, 3, 64, 64), generator=g), dtype=torch.bfloat16))
        for _ in range(2)]
    bias = (0.1 * torch.randn(64, generator=g)).repeat(2).to(dev)
    for name in KERNELS:
        for tag, b, kw in (("+stats", None, dict(stats=True)),
                           (" bias_relu", bias, dict(bias_relu=True))):
            conv_err(TC, name, [x, dy], ws, b,
                     f"{name}{tag} (3, 520, 516) bf16", **kw)
            first, second = (call(TC, name, [x, dy], ws, b, **kw)
                             for _ in range(2))
            if not kw.get("stats"):
                first, second = (first,), (second,)
            if not all(torch.equal(u, v) for u, v in zip(first, second)):
                raise AssertionError(f"{name}{tag} differs between two calls")
            log(f"[check] {name}{tag} (3, 520, 516) bf16: two calls "
                f"bit-identical")


def time_train_kernels(TC, dev) -> tuple:
    """Training shape: N=16 packed samples (bench.py's batch 8), bf16. Each
    kernel is first compared with its plain version on the inputs it is
    timed on; those errors go into the kernels line.
    Library yardsticks, never called by the port: for conv+stats and the
    input-gradient conv (dx: dy through the forward kernel with
    flip-transposed taps, no epilogue) cuDNN's conv alone (no call
    computes the conv with its statistics); for dw cuDNN's weight gradient
    (aten.convolution_backward, output mask [False, True, False]) on the
    unpacked channels-last tensors. Kernels and yardsticks are timed with
    the L2 cache flushed before each call (cold, as a train step finds
    them) and by the profiler's device time (no host work inside), the
    convs also warm (``timed``)."""
    n, dtype = N_TRAIN, torch.bfloat16
    xs, ws, w64, _ = kernel_inputs(TC, n, dtype, dev, seed=SEED + 3)
    out, errs = {}, {}
    unpacked = [x.reshape(n, H, W, 64).permute(0, 3, 1, 2) for x in xs]
    for name, meta in KERNELS.items():
        nin = meta["nin"]
        errs[name + "+stats"] = conv_err(TC, name, xs, ws, None,
                                         f"{name}+stats N={n} bf16",
                                         stats=True)
        torch.cuda.empty_cache()
        t = timed(lambda: call(TC, name, xs, ws, None, stats=True))
        t["plain_ms"] = cuda_ms(lambda: call(TC, name, xs, ws, None,
                                             plain=True, stats=True),
                                reps=3, warmup=1)
        torch.cuda.empty_cache()
        x_lib = torch.cat(unpacked[:nin], dim=1) if nin > 1 else unpacked[0]
        w_lib = torch.cat([w.to(dev, dtype) for w in w64[:nin]], dim=2)
        w_lib = w_lib.permute(3, 2, 0, 1).contiguous()
        t.update(timed(lambda: torch.nn.functional.conv2d(
            x_lib, w_lib, padding=1), "library_"))
        del x_lib
        torch.cuda.empty_cache()
        b_ms, b_by = bound(nin, n, dtype, stats=True)
        out[name + "+stats"] = dict(
            **t, bound_ms=b_ms, bound_by=b_by, l2="cold",
            library_call="F.conv2d alone (cuDNN), no stats")
        log_conv_time(f"{name}+stats N={n}", out[name + "+stats"])
    # the input-gradient conv of the train step (_ConvWp.backward)
    w_dx = TC.flip_transpose(w64[0].to(dev, dtype))
    got = TC._conv_w([xs[1]], [w_dx])
    ref = TC.conv3x3_wp_plain(xs[1], *TC.make_wc_we(w_dx, dtype=dtype),
                              out_dtype=torch.float32)
    dx_err, top = (got.float() - ref).abs().max().item(), ref.abs().max().item()
    ok = dx_err <= 2e-2 * top
    log(f"[check] conv3x3_wp dx (flip-transposed taps) N={n} bf16: y "
        f"{dx_err:.3e} (max {top:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dx conv disagrees with its plain version")
    errs["conv3x3_wp+dx"] = dx_err
    del got, ref
    # two launches a call: the copy that makes the flipped taps contiguous
    # (as in the train step) and the conv
    t = timed(lambda: TC._conv_w([xs[1]], [w_dx]), kernels=2)
    t["plain_ms"] = cuda_ms(lambda: TC.conv3x3_wp_plain(
        xs[1], *TC.make_wc_we(w_dx, dtype=dtype)), reps=3, warmup=1)
    torch.cuda.empty_cache()
    w_lib = w_dx.permute(3, 2, 0, 1).contiguous()
    t.update(timed(lambda: torch.nn.functional.conv2d(
        unpacked[1], w_lib, padding=1), "library_"))
    b_ms, b_by = bound(1, n, dtype)
    out["conv3x3_wp+dx"] = dict(**t, bound_ms=b_ms, bound_by=b_by, l2="cold",
                                library_call="F.conv2d alone (cuDNN)")
    log_conv_time(f"conv3x3_wp dx N={n}", out["conv3x3_wp+dx"])
    x, dy = xs
    errs["conv3x3_wp_dw"] = dw_err(TC, x, dy, f"conv3x3_wp_dw N={n} bf16")
    kernel = lambda: TC.conv3x3_wp_dw(x, dy)
    ms = cold_ms(kernel)
    dev_ms = device_ms(kernel, kernels=2)       # dw_bf16, dw_reduce
    q_ms = queued_ms(kernel)
    plain_ms = cuda_ms(lambda: TC.conv3x3_wp_dw_plain(x, dy), reps=3,
                       warmup=1)
    torch.cuda.empty_cache()
    w_lib = w64[0].to(dev, dtype).permute(3, 2, 0, 1).contiguous()
    library = lambda: torch.ops.aten.convolution_backward(
        unpacked[1], unpacked[0], w_lib, None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, [False, True, False])
    # the yardstick must compute dw too: [co, ci, kh, kw] bf16 -> HWIO,
    # within bf16 rounding of the plain version
    ref = TC.conv3x3_wp_dw_plain(x, dy)
    lib_rel = ((library()[1].permute(2, 3, 1, 0).float() - ref).abs().max()
               / ref.abs().max()).item()
    del ref
    if not lib_rel <= 1e-2:
        raise AssertionError(f"cuDNN's weight gradient is {lib_rel:.2e} of "
                             "max|dw| off the plain version")
    lib_ms = cold_ms(library)
    lib_dev_ms = device_ms(library)
    lib_q_ms = queued_ms(library)
    b_ms, b_by = bound(1, n, dtype, dw=True)
    out["conv3x3_wp_dw"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by, device_ms=dev_ms, queued_ms=q_ms,
        library_device_ms=lib_dev_ms, library_queued_ms=lib_q_ms,
        library_call="aten.convolution_backward, dw only", l2="cold")
    log(f"[time] conv3x3_wp_dw N={n} {H}x{W} bf16, cold L2: kernel {ms:.3f} "
        f"ms (profiler device {fmt_ms(dev_ms)}, queued {q_ms:.3f}), plain "
        f"{plain_ms:.3f} ms, cuDNN weight gradient {lib_ms:.3f} ms (device "
        f"{fmt_ms(lib_dev_ms)}, queued {lib_q_ms:.3f}, "
        f"{lib_rel:.1e} of max|dw| from the plain version), bound "
        f"{b_ms:.3f} ms ({b_by}); kernel at {b_ms / ms:.1%} of its bound, "
        f"cuDNN at {b_ms / lib_ms:.1%}")
    return out, errs


def time_kernels(TC, dev) -> dict:
    """Serving shape: N=64 packed samples (bench.py's batch 32), bf16, each
    kernel first compared with its plain version on the inputs it is timed
    on."""
    n, dtype = 64, torch.bfloat16
    xs, ws, w64, bias = kernel_inputs(TC, n, dtype, dev, seed=SEED + 1)
    out = {}
    for name, meta in KERNELS.items():
        nin = meta["nin"]
        conv_err(TC, name, xs, ws, bias, f"{name} N={n} bf16 bias_relu=True",
                 bias_relu=True)
        torch.cuda.empty_cache()
        t = timed(lambda: call(TC, name, xs, ws, bias, bias_relu=True))
        t["plain_ms"] = cuda_ms(lambda: call(TC, name, xs, ws, bias,
                                             plain=True, bias_relu=True),
                                reps=3, warmup=1)
        torch.cuda.empty_cache()
        # library yardstick: cuDNN conv + bias on the unpacked channels-last
        # tensor (the two-input form on a concat built outside the timing)
        x_lib = torch.cat([x.reshape(n, H, W, 64) for x in xs[:nin]],
                          dim=-1).permute(0, 3, 1, 2)
        w_lib = torch.cat([w.to(dev, dtype) for w in w64[:nin]], dim=2)
        w_lib = w_lib.permute(3, 2, 0, 1).contiguous()
        b_lib = bias[:64].to(dtype)
        t.update(timed(lambda: torch.nn.functional.conv2d(
            x_lib, w_lib, b_lib, padding=1), "library_"))
        del x_lib
        torch.cuda.empty_cache()
        b_ms, b_by = bound(nin, n, dtype)
        out[name] = dict(**t, bound_ms=b_ms, bound_by=b_by, l2="cold",
                         library_call="F.conv2d with bias (cuDNN), no ReLU")
        log_conv_time(f"{name} bias_relu N={n}", out[name])
    return out


def log_conv_time(tag: str, t: dict) -> None:
    log(f"[time] {tag} {H}x{W} bf16, cold L2: kernel {t['ms']:.3f} ms "
        f"(profiler device {fmt_ms(t['device_ms'])}, queued "
        f"{t['queued_ms']:.3f}, warm {t['warm_ms']:.3f}), plain "
        f"{t['plain_ms']:.3f} ms, {t['library_call']} "
        f"{t['library_ms']:.3f} ms (device {fmt_ms(t['library_device_ms'])}, "
        f"queued {t['library_queued_ms']:.3f}, warm "
        f"{t['library_warm_ms']:.3f}), bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}); kernel at {t['bound_ms'] / t['ms']:.1%} of its "
        f"bound")


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def frames(n: int, seed: int) -> np.ndarray:
    """Smooth clutter plus a few bright blobs, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.empty((n, H, W, 1), np.float32)
    for i in range(n):
        img = 0.3 + 0.1 * rng.standard_normal((H, W)).astype(np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            r = rng.uniform(8, 40)
            img += 0.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                / (2 * r * r))
        out[i, ..., 0] = np.clip(img, 0, 1)
    return out


def post(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def serve(TC, dev) -> dict:
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import param_count
    from onet_tpu_torch.serve.http import ServingSession, start_server

    gen = torch.Generator().manual_seed(SEED)
    params, state = onet_init(gen, 1, base=64)
    # non-trivial running statistics, so folding is exercised
    def perturb(tree):
        if "var" in tree:
            c = tree["var"].shape
            return {"mean": (0.1 * torch.randn(c, generator=gen)).to(dev),
                    "var": (0.5 + torch.rand(c, generator=gen)).to(dev)}
        return {k: perturb(v) for k, v in tree.items()}

    state = perturb(state)
    folded = fold_onet(params, state)
    log(f"[serve] Onet base 64, {param_count(params)} params, seed {SEED}")

    def step(f, xb):
        return onet_infer(f, xb, policy=BF16_COMPUTE, pair_pack=True)

    batch = 8
    sess = ServingSession(step, folded, batch=batch, in_channels=1,
                          mode="bf16", model_name=f"random-seed-{SEED}",
                          input_hw=(H, W))
    sess.warmup()
    httpd = start_server(sess, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    reqs = [frames(batch, SEED + 10 + i) for i in range(3)]
    try:
        TC.conv3x3_wp_raw.launches = 0
        TC.conv3x3_wp2_raw.launches = 0
        masks = [post(url + "/segment", r) for r in reqs]
        launches = {"conv3x3_wp": TC.conv3x3_wp_raw.launches,
                    "conv3x3_wp2": TC.conv3x3_wp2_raw.launches}
        health = get_json(url + "/healthz")
        stats = get_json(url + "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    if th.is_alive():
        raise AssertionError("HTTP server thread did not stop")
    log(f"[serve] launches in 3 requests: {launches}; healthz {health}; "
        f"stats {stats}")
    if launches != {"conv3x3_wp": 2 * 3, "conv3x3_wp2": 1 * 3}:
        raise AssertionError(f"kernel launches {launches}, expected 6 and 3")
    if health["status"] != "ok" or stats["requests"] != 3 or \
            stats["frames"] != 3 * batch:
        raise AssertionError("healthz/stats disagree with the requests")

    agree = []
    with torch.inference_mode():
        for r, m in zip(reqs, masks):
            x = torch.from_numpy(r).to(dev)
            s, lab = step(folded, x)
            if m.shape != (batch, H, W) or m.dtype != np.uint8:
                raise AssertionError(f"response {m.shape} {m.dtype}")
            if not torch.isfinite(s).all():
                raise AssertionError("non-finite S")
            if not np.array_equal(m, lab.cpu().numpy().astype(np.uint8)):
                raise AssertionError("HTTP masks differ from onet_infer")
            _, lab_st = onet_infer(folded, x, policy=BF16_COMPUTE,
                                   pair_pack=False)
            agree.append(float((lab_st == lab).float().mean()))
        fg = float(np.mean([m.mean() for m in masks]))
        log(f"[serve] wp vs stacked bf16 mask agreement {agree}; "
            f"foreground share {fg:.4f}")
        if min(agree) < 0.99:
            raise AssertionError(f"wp/stacked agreement {min(agree)} < 0.99")

        x2 = torch.from_numpy(reqs[0][:2]).to(dev)
        s_wp, _ = onet_infer(folded, x2, policy=DEFAULT, pair_pack=True)
        s_st, _ = onet_infer(folded, x2, policy=DEFAULT, pair_pack=False)
        d32 = (s_wp - s_st).abs().max().item()
        log(f"[serve] fp32 batch 2: max |S_wp - S_stacked| = {d32:.3e}")
        if not d32 <= 1e-3:
            raise AssertionError(f"fp32 wp/stacked S differ by {d32}")

        perf = {"http_request_ms_p50": stats["total_ms"]["p50"]}
        for b in (8, 32):
            xb = torch.from_numpy(
                np.concatenate([reqs[0]] * (b // batch))).to(dev)
            for wp in (True, False):
                ms = cuda_ms(lambda: onet_infer(
                    folded, xb, policy=BF16_COMPUTE, pair_pack=wp),
                    reps=5, warmup=2)
                key = f"b{b}_{'wp' if wp else 'stacked'}"
                perf[key + "_step_ms"] = ms
                perf[key + "_frames_per_s"] = b / ms * 1e3
                if b == batch:
                    breakdown(lambda: onet_infer(
                        folded, xb, policy=BF16_COMPUTE, pair_pack=wp),
                        f"batch {b} {'wp' if wp else 'stacked'} step")
                torch.cuda.empty_cache()
    return dict(launches=launches, agreement=min(agree), fp32_s_diff=d32,
                **perf)


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def _clone(tree):
    from onet_tpu_torch.models.unet import tree_map
    return tree_map(torch.clone, tree)


@contextlib.contextmanager
def pair_pack(O, on: bool):
    """models.onet.PAIR_PACK (the module-wide layout switch) set to ``on``
    inside the block and restored on every way out of it, a raise
    included."""
    old = O.PAIR_PACK
    O.PAIR_PACK = on
    try:
        yield
    finally:
        O.PAIR_PACK = old


def _loss_and_grads(params, state, x, policy, pair_pack):
    """Loss and the flat gradient of one training forward."""
    from onet_tpu_torch.models.onet import compute_loss, onet_forward
    from onet_tpu_torch.models.unet import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with policy.precision():
        out, _ = onet_forward(p, _clone(state), x, train=True, policy=policy,
                              pair_pack=pair_pack)
        loss = compute_loss(out)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.item(), torch.cat([g.reshape(-1).double() for g in grads])


def train(TC, dev) -> dict:
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.models.unet import tree_leaves
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_eval_step, make_train_step

    gen = torch.Generator().manual_seed(SEED + 20)
    params0, state0 = O.onet_init(gen, 1, base=64)
    batch = 8
    xs = [torch.from_numpy(frames(batch, SEED + 30 + i)).to(dev)
          for i in range(TRAIN_STEPS)]

    # the main path: bench.py's step (ONET_PAIR_PACK=1), pair-packed
    params, state, opt = _clone(params0), _clone(state0), adam_init(params0)
    for k in ("conv3x3_wp_raw", "conv3x3_wp2_raw", "conv3x3_wp_dw"):
        setattr(getattr(TC, k), "launches", 0)
    TC.conv3x3_wp_raw.stats_launches = TC.conv3x3_wp2_raw.stats_launches = 0
    losses = []
    with pair_pack(O, True):
        step = make_train_step(policy=BF16_COMPUTE)
        for x in xs:
            params, state, opt, loss = step(params, state, opt, x, LR)
            losses.append(loss.item())
    launches = {"conv3x3_wp": TC.conv3x3_wp_raw.launches,
                "conv3x3_wp2": TC.conv3x3_wp2_raw.launches,
                "conv3x3_wp_dw": TC.conv3x3_wp_dw.launches,
                "conv3x3_wp+stats": TC.conv3x3_wp_raw.stats_launches,
                "conv3x3_wp2+stats": TC.conv3x3_wp2_raw.stats_launches}
    log(f"[train] wp bf16 batch {batch}: losses {losses}; launches in "
        f"{TRAIN_STEPS} steps {launches}")
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    want.update({"conv3x3_wp+stats": 2 * TRAIN_STEPS,
                 "conv3x3_wp2+stats": TRAIN_STEPS})
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError("non-finite parameter after training")
    moved = sum(not torch.equal(a, b) for a, b in
                zip(tree_leaves(state), tree_leaves(state0)))
    log(f"[train] BN running-stat leaves moved: {moved} of "
        f"{len(tree_leaves(state))}")
    if moved != len(tree_leaves(state)):
        raise AssertionError("BatchNorm running stats did not all move")

    # the stacked step (cuDNN only) from the same start, bf16 batch 8
    with pair_pack(O, False):
        step_st = make_train_step(policy=BF16_COMPUTE)
        _, _, _, loss_st = step_st(_clone(params0), _clone(state0),
                                   adam_init(params0), xs[0], LR)
    bf16_rel = abs(loss_st.item() - losses[0]) / abs(losses[0])
    log(f"[train] bf16 batch {batch} first-step loss: wp {losses[0]:.6f}, "
        f"stacked {loss_st.item():.6f}, relative difference {bf16_rel:.3e}")
    if not bf16_rel <= 1e-2:
        raise AssertionError(f"bf16 wp/stacked loss differ by {bf16_rel}")

    # fp32 batch 2: loss within 1e-4, gradient cosine > 0.9999 (the JAX
    # package's wp-vs-stacked contract, tests/test_wp_path.py)
    x2 = xs[0][:2]
    l_wp, g_wp = _loss_and_grads(params0, state0, x2, DEFAULT, True)
    l_st, g_st = _loss_and_grads(params0, state0, x2, DEFAULT, False)
    cos = float((g_wp @ g_st) / (g_wp.norm() * g_st.norm()))
    rel_g = float((g_wp - g_st).norm() / g_st.norm())
    l_rel = abs(l_wp - l_st) / abs(l_st)
    log(f"[train] fp32 batch 2: loss wp {l_wp:.7f} stacked {l_st:.7f} "
        f"(relative {l_rel:.3e}); gradient cosine {cos:.7f}, relative L2 "
        f"{rel_g:.3e}")
    if not (l_rel <= 1e-4 and cos > 0.9999):
        raise AssertionError("fp32 wp/stacked train paths disagree")
    del g_wp, g_st

    # step time (CUDA events, median of 5 after 2 warm-ups), frames/s
    perf = {}
    for wp in (True, False):
        key = "wp" if wp else "stacked"
        p, st, o = _clone(params0), _clone(state0), adam_init(params0)
        with pair_pack(O, wp):
            fn_step = make_train_step(policy=BF16_COMPUTE)
            ms = cuda_ms(lambda: fn_step(p, st, o, xs[0], LR))
            perf[f"train_b{batch}_{key}_step_ms"] = ms
            perf[f"train_b{batch}_{key}_frames_per_s"] = batch / ms * 1e3
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn_step(p, st, o, xs[0], LR)
            torch.cuda.synchronize()
            perf[f"train_b{batch}_{key}_peak_gib"] = (
                torch.cuda.max_memory_allocated() / 2 ** 30)
            if wp:
                breakdown(lambda: fn_step(p, st, o, xs[0], LR),
                          f"train step batch {batch} wp", top=14)
        log(f"[train] {key} bf16 batch {batch}: step {ms:.2f} ms, "
            f"{batch / ms * 1e3:.1f} frames/s, peak "
            f"{perf[f'train_b{batch}_{key}_peak_gib']:.2f} GiB")
        del p, st, o
        torch.cuda.empty_cache()

    # one eval step on the trained weights, labels from the frames' blobs
    labels = (xs[0][..., 0] > 0.6).to(torch.int32)
    with pair_pack(O, True):
        metrics, loss_ev, pred = make_eval_step(policy=BF16_COMPUTE)(
            params, state, xs[0], labels)
    metrics = {k: float(v) for k, v in metrics.items()}
    log(f"[train] eval step: loss {loss_ev.item():.6f}, metrics {metrics}, "
        f"label share {float(labels.float().mean()):.4f}")
    if pred.shape != (batch, H, W) or not np.isfinite(loss_ev.item()) or \
            not all(0.0 <= v <= 1.0 for v in metrics.values()):
        raise AssertionError(f"eval step output off: {metrics}")
    return dict(launches=launches, losses=losses, bf16_loss_rel=bf16_rel,
                fp32_loss_rel=l_rel, fp32_grad_cos=cos, fp32_grad_rel=rel_g,
                eval=metrics, **perf)


# ---------------------------------------------------------------------------
# phase 5: the head, min-max and native-layout conv kernels
# ---------------------------------------------------------------------------

def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), in f32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def checked(tag, pairs) -> float:
    """Log and assert [(label, got, ref, rel_tol)]; returns the largest
    absolute error."""
    msg, ok, worst = [], True, 0.0
    for label, got, ref, tol in pairs:
        err, rel = rel_err(got, ref)
        ok = ok and rel <= tol
        worst = max(worst, err)
        msg.append(f"{label} {err:.3e} ({rel:.2e} of max, tol {tol:g})")
    log(f"[check] {tag}: {', '.join(msg)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees")
    return worst


def head_err(HD, ts, tag, tol) -> tuple:
    """jsd_loss_fwd and jsd_loss_bwd (through autograd) against their
    plain versions: the loss within 1e-5 relative, each gradient within
    ``tol`` of its largest magnitude. Returns (largest absolute error,
    the kernel's gradients)."""
    ts = [t.detach().requires_grad_(True) for t in ts]
    loss = HD.fused_jsd_loss(*ts)
    grads = torch.autograd.grad(loss, ts)
    flat = [t.detach() for t in ts]
    npix = flat[0].numel() // flat[0].shape[-1]
    scale = torch.full((1,), 1.0 / (2 * npix), device=flat[0].device)
    refs = HD.jsd_loss_bwd_plain(*flat, scale)
    err = checked(tag, [("loss", loss, HD.jsd_loss_fwd_plain(*flat), 1e-5)]
                  + [(f"d{n}", g, r, tol) for n, g, r in
                     zip(("Lt", "Ht", "Ld", "Hd"), grads, refs)])
    return err, grads


def same_bits(got, ref) -> bool:
    """torch.equal with NaN positions compared apart: the same NaN mask and
    equal values everywhere else."""
    nan = got.isnan()
    return torch.equal(nan, ref.isnan()) and torch.equal(
        got.masked_fill(nan, 0), ref.masked_fill(nan, 0))


def minmax_plan_line(HD, x, tag) -> None:
    """The min-max set-up's choice for x: CTAs a frame, form, shared
    memory, co-resident clusters."""
    p = HD.minmax_plan(x)
    log(f"[minmax] {tag}: K={p.k}, {'streaming' if p.streaming else 'resident'}"
        f", {p.smem} B shared memory a CTA, {p.clusters} clusters of K "
        f"co-resident")


def minmax_err(HD, x, tag) -> float:
    """minmax_complement and paired_input against the plain version:
    bit-equal, NaN positions included (IEEE division on both sides).
    Returns the largest absolute difference over the non-NaN values (0)."""
    xn, xc = HD.minmax_complement(x)
    pair = HD.paired_input(x)
    rn, rc = HD.minmax_complement_plain(x)
    ok, worst, nans = True, 0.0, 0
    for got, ref in ((xn, rn), (xc, rc), (pair, torch.cat([rn, rc]))):
        ok = ok and same_bits(got, ref)
        keep = ~(got.isnan() | ref.isnan())
        if keep.any():
            worst = max(worst, (got[keep].float() - ref[keep].float()).abs()
                        .max().item())
        nans += int(ref.isnan().sum().item())
    log(f"[check] {tag}: xn, xc, pair {'bit-equal' if ok else 'DIFFER'} to "
        f"the plain version ({nans} NaN outputs, max |diff| {worst:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees")
    return worst


def minmax_cases(HD, dev, g):
    """The min-max kernel against its plain version, f32 and bf16: ragged
    and misaligned frames (m * sizeof(T) not a multiple of 16 at B >= 3, so
    frame starts and paired_input's second half are misaligned), NaN /
    +-inf / constant frames (small, and past the first CTA's share of a
    clustered 512^2 frame) and frames that take the streaming form."""
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for shape in ((2, 37, 53, 1), (3, 37, 53, 1), (4, 29, 31, 3),
                      (1, 1024, 1500, 1), (1, 2048, 1600, 1)):
            x = (3 * torch.rand(shape, generator=g) - 1).to(dev, dtype)
            minmax_plan_line(HD, x, f"{shape} {dt}")
            minmax_err(HD, x, f"minmax {shape} {dt}")
        for shape in ((3, 37, 53, 1), (2, 512, 512, 1)):
            for case in ("nan", "posinf", "neginf", "constant"):
                x = 3 * torch.rand(shape, generator=g) - 1
                if case == "constant":
                    x[-1] = 2.5
                else:
                    x[-1, shape[1] - 3, shape[2] // 2, 0] = float(
                        {"nan": "nan", "posinf": "inf",
                         "neginf": "-inf"}[case])
                x = x.to(dev, dtype)
                if case == "nan":
                    minmax_plan_line(HD, x, f"{shape} {dt}")
                minmax_err(HD, x, f"minmax {shape} {case} {dt}")
    torch.cuda.empty_cache()


def bd_err(BD, xs, ws, tag) -> float:
    """The bd kernel with stats against its plain version: y in the
    default dtype (1e-2 of max|y| for bf16 out, one rounding; 1e-4 f32),
    s1/s2 within SUM_REL of their max."""
    raw = BD.conv3x3_bd_raw if len(xs) == 1 else BD.conv3x3_bd2in_raw
    plain = BD.conv3x3_bd_plain if len(xs) == 1 else BD.conv3x3_bd2in_plain
    y, s1, s2 = raw(*xs, *ws, stats=True)
    ry, rs1, rs2 = plain(*xs, *ws, stats=True, out_dtype=torch.float32)
    tol = 1e-2 if y.dtype == torch.bfloat16 else 1e-4
    return checked(tag, [("y", y, ry, tol), ("s1", s1, rs1, SUM_REL),
                         ("s2", s2, rs2, SUM_REL)])


def small_phase5_checks(HD, BD, dev):
    """Each new kernel against its plain version at small shapes, f32 and
    bf16: head pixel counts with no multiple-of-8 divisor (15), min-max
    through ``minmax_cases``, bd at N=4 with H and W not multiples of the
    8x32 tile."""
    g = torch.Generator().manual_seed(SEED + 50)
    for dtype in (torch.float32, torch.bfloat16):
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        dt = str(dtype)[6:]
        for shape in ((1, 3, 5, 64), (2, 8, 16, 64)):
            ts = [torch.randn(shape, generator=g).to(dev, dtype)
                  for _ in range(4)]
            head_err(HD, ts, f"head {shape} {dt}", tol)
        xs = [torch.randn((4, 60, 100, 128), generator=g).to(dev, dtype)
              for _ in range(2)]
        ws = [(0.05 * torch.randn((3, 3, 128, 128), generator=g))
              .to(dev, dtype) for _ in range(2)]
        for nin in (1, 2):
            bd_err(BD, xs[:nin], ws[:nin], f"conv3x3_bd nin={nin} "
                   f"(4, 60, 100) {dt}")
    minmax_cases(HD, dev, g)
    # bf16 with stats at (3, 131, 260): 198 tiles of 2 rows x 128 pixels
    # to a sample, 594 over an H100's 132 CTAs in ranges of 5 (the last
    # run past the end), two of which cross samples; the W edge cuts a
    # tile, the H edge a row pair. Twice, the stats bit-identical
    xs = [torch.randn((3, 131, 260, 128), generator=g).to(dev, torch.bfloat16)
          for _ in range(2)]
    ws = [(0.05 * torch.randn((3, 3, 128, 128), generator=g))
          .to(dev, torch.bfloat16) for _ in range(2)]
    for nin in (1, 2):
        raw = BD.conv3x3_bd_raw if nin == 1 else BD.conv3x3_bd2in_raw
        bd_err(BD, xs[:nin], ws[:nin], f"conv3x3_bd nin={nin} "
               f"(3, 131, 260) bfloat16")
        a, b = (raw(*xs[:nin], *ws[:nin], stats=True) for _ in range(2))
        same = torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        log(f"[check] conv3x3_bd nin={nin} (3, 131, 260) stats twice: "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("conv_bd stats differ between two calls")
    torch.cuda.empty_cache()


def head_features(dev):
    """loc, glob [8, 512, 512, 128] of one full-width training forward of
    the weight-shared Onet (base 64, seeded random weights, bf16), taken
    from unet_apply_stacked as onet_forward takes them, and the frames."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import unet_apply_stacked
    from onet_tpu_torch.ops.normalize import complement

    params, state = onet_init(torch.Generator().manual_seed(SEED + 60), 1,
                              base=64)
    x = torch.from_numpy(frames(8, SEED + 61)).to(dev)
    with torch.no_grad(), BF16_COMPUTE.precision():
        (loc, glob), _ = unet_apply_stacked(
            params["top"], state["top"], torch.cat([x, complement(x)], -1),
            train=True, policy=BF16_COMPUTE)
    log(f"[phase5] forward features loc {tuple(loc.shape)} {loc.dtype}, "
        f"glob {glob.dtype}")
    return loc.to(torch.bfloat16), glob.to(torch.bfloat16), x


def halves(loc, glob):
    """Lt, Ht, Ld, Hd: the four contiguous per-branch halves."""
    c = loc.shape[-1] // 2
    return [t.contiguous() for t in (loc[..., :c], glob[..., :c],
                                     loc[..., c:], glob[..., c:])]


def stacked_loss(loc, glob):
    """compute_loss of the OnetOutput onet_forward builds from (loc, glob)
    on the stacked path: the eager formulation of the train step."""
    from onet_tpu_torch.models import onet as O
    v, lsum = O.stacked_head(loc, glob)
    c = loc.shape[-1] // 2
    out = O.OnetOutput(Lt=loc[..., :c], Ld=loc[..., c:], Vt=v[..., 0],
                       Vd=v[..., 1], S=torch.softmax(v, dim=-1), Lsum=lsum)
    return O.compute_loss(out)


def head_minmax_bd(dev) -> list:
    """Phase 5: the JSD head, min-max and native-layout conv kernels.
    Small-shape checks; the main path, counted (fused_jsd_loss forward and
    backward on the features of a full-width bf16 forward at batch 8,
    paired_input on the train batch's frames, the bd probe's two sites
    through the probe module); checks of those outputs; timings; the
    probe. Returns the kernels line's rows."""
    from onet_tpu_torch.ops import conv_bd as BD
    from onet_tpu_torch.ops import head as HD
    from onet_tpu_torch.ops.normalize import complement, minmax_per_frame
    from onet_tpu_torch.runs import bd_epilogue_probe as probe

    small_phase5_checks(HD, BD, dev)
    loc, glob, x = head_features(dev)
    feats = halves(loc, glob)
    bd_in = probe.inputs(dev, seed=SEED)

    # the main path, counted
    counted = {"jsd_loss_fwd": HD.jsd_loss_fwd,
               "jsd_loss_bwd": HD.jsd_loss_bwd,
               "minmax_complement": HD.minmax_complement,
               "conv3x3_bd+stats": BD.conv3x3_bd_raw,
               "conv3x3_bd2in+stats": BD.conv3x3_bd2in_raw}
    for fn in counted.values():
        fn.launches = 0
    ts = [t.detach().requires_grad_(True) for t in feats]
    loss = HD.fused_jsd_loss(*ts)
    grads = torch.autograd.grad(loss, ts)
    pair = HD.paired_input(x)
    site1 = probe.site1(bd_in[0], bd_in[2])
    site2 = probe.site2(*bd_in[:2], *bd_in[3:])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    log(f"[phase5] launches on the main path: {launches}; loss "
        f"{loss.item():.7f}, probe sites {site1.item():.4f} "
        f"{site2.item():.4f}")
    if launches != {k: 1 for k in counted}:
        raise AssertionError(f"phase 5 launches {launches}, expected 1 each")
    if not (torch.isfinite(site1) and torch.isfinite(site2)):
        raise AssertionError("non-finite probe result")

    errs = {}
    # head, bf16 as the forward gives it: kernel against plain and against
    # compute_loss of the same forward; gradients against plain and
    # against autograd through the stacked head
    flat = [t.detach() for t in ts]
    npix = flat[0].numel() // flat[0].shape[-1]
    scale = torch.full((1,), 1.0 / (2 * npix), device=dev)
    ref_loss = HD.jsd_loss_fwd_plain(*flat)
    ref_grads = HD.jsd_loss_bwd_plain(*flat, scale)
    errs["jsd_loss_fwd"] = checked("head loss 8x512x512x64 bf16", [
        ("plain", loss, ref_loss, 1e-5),
        ("compute_loss", loss, stacked_loss(loc, glob), 1e-5)])
    errs["jsd_loss_bwd"] = checked("head grads 8x512x512x64 bf16", [
        (f"d{n}", g, r, 1e-2) for n, g, r in
        zip(("Lt", "Ht", "Ld", "Hd"), grads, ref_grads)])
    lv, gv = loc.detach().requires_grad_(True), glob.detach().requires_grad_(
        True)
    dloc, dglob = torch.autograd.grad(stacked_loss(lv, gv), (lv, gv))
    auto = halves(dloc, dglob)
    checked("head grads vs autograd of the stacked head, bf16", [
        (f"d{n}", g, a, 1e-2) for n, g, a in
        zip(("Lt", "Ht", "Ld", "Hd"), grads, auto)])
    del dloc, dglob, auto, lv, gv
    # f32 at full width: the same features upcast
    _, g32 = head_err(HD, [t.float() for t in flat],
                      "head 8x512x512x64 f32", 1e-4)
    lv, gv = (loc.float().requires_grad_(True),
              glob.float().requires_grad_(True))
    dloc, dglob = torch.autograd.grad(stacked_loss(lv, gv), (lv, gv))
    checked("head grads vs autograd of the stacked head, f32", [
        (f"d{n}", g, a, 1e-3) for n, g, a in
        zip(("Lt", "Ht", "Ld", "Hd"), g32, halves(dloc, dglob))])
    del g32, dloc, dglob, lv, gv
    torch.cuda.empty_cache()

    # min-max on the train batch's frames
    rn, rc = HD.minmax_complement_plain(x)
    minmax_plan_line(HD, x, "the train frames [8,512,512,1] f32")
    same = same_bits(pair, torch.cat([rn, rc]))
    errs["minmax_complement"] = (pair - torch.cat([rn, rc])).abs().max().item()
    log(f"[check] paired_input [8,512,512,1] f32 on the main path: "
        f"{'bit-equal to' if same else 'DIFFERS from'} the plain version")
    if not same:
        raise AssertionError("paired_input on the train frames disagrees")
    ops_n = minmax_per_frame(x)
    checked("paired_input vs complement(minmax_per_frame(x))", [
        ("xn", pair[:8], ops_n, 1e-6),
        ("xc", pair[8:], complement(ops_n), 1e-6)])

    # bd at the probe's sites (N=8, 512x512, bf16)
    errs["conv3x3_bd+stats"] = bd_err(BD, bd_in[:1], bd_in[2:3],
                                      "conv3x3_bd probe site N=8 bf16")
    errs["conv3x3_bd2in+stats"] = bd_err(BD, bd_in[:2], bd_in[3:],
                                         "conv3x3_bd2in probe site N=8 bf16")
    torch.cuda.empty_cache()

    # timings: kernel, plain, bound, and a library call or the eager
    # formulation of the train step where no single call computes it
    times = {}
    act = npix * 64 * 2           # bytes of one bf16 half
    # cold L2, profiler device time and warm, as the conv rows
    times["jsd_loss_fwd"] = dict(
        **timed(lambda: HD.jsd_loss_fwd(*flat), kernels=2),
        plain_ms=cuda_ms(lambda: HD.jsd_loss_fwd_plain(*flat), reps=3,
                         warmup=1),
        bound_ms=(4 * act + 4) / HBM * 1e3, bound_by="bytes",
        library_ms=None,
        eager_ms=cuda_ms(lambda: stacked_loss(loc, glob)),
        eager_call="stacked_head + softmax + jsd_loss_pair, forward")

    def eager_fwd_bwd():
        lv_ = loc.detach().requires_grad_(True)
        gv_ = glob.detach().requires_grad_(True)
        return torch.autograd.grad(stacked_loss(lv_, gv_), (lv_, gv_))

    times["jsd_loss_bwd"] = dict(
        **timed(lambda: HD.jsd_loss_bwd(*flat, scale), kernels=1),
        plain_ms=cuda_ms(lambda: HD.jsd_loss_bwd_plain(*flat, scale),
                         reps=3, warmup=1),
        bound_ms=8 * act / HBM * 1e3, bound_by="bytes", library_ms=None,
        eager_ms=cuda_ms(eager_fwd_bwd),
        eager_call="stacked_head + softmax + jsd_loss_pair, forward and "
                   "backward (autograd)")
    torch.cuda.empty_cache()
    times["minmax_complement"] = dict(
        **timed(lambda: HD.minmax_complement(x), kernels=1),
        plain_ms=cuda_ms(lambda: HD.minmax_complement_plain(x)),
        bound_ms=3 * x.numel() * 4 / HBM * 1e3, bound_by="bytes",
        library_ms=None,
        eager_ms=cuda_ms(lambda: complement(minmax_per_frame(x))),
        eager_call="minmax_per_frame + complement")
    # its one launch; with host activity traced too, the profiler lost this
    # call's record here in every try
    breakdown(lambda: HD.minmax_complement(x), "minmax_complement "
              "[8,512,512,1] f32", top=4, kernels=1, host=False)
    n_bd = bd_in[0].shape[0]
    for key, nin in (("conv3x3_bd+stats", 1), ("conv3x3_bd2in+stats", 2)):
        xs, ws = bd_in[:nin], (bd_in[2:3] if nin == 1 else bd_in[3:])
        raw = BD.conv3x3_bd_raw if nin == 1 else BD.conv3x3_bd2in_raw
        plain = BD.conv3x3_bd_plain if nin == 1 else BD.conv3x3_bd2in_plain
        # cold L2, profiler device time and warm, as the conv_wp rows; cuDNN's
        # conv alone the same way (inputs laid out outside the timing)
        t = timed(lambda: raw(*xs, *ws, stats=True))
        t["plain_ms"] = cuda_ms(lambda: plain(*xs, *ws, stats=True), reps=3,
                                warmup=1)
        torch.cuda.empty_cache()
        x_lib = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
        w_lib = torch.cat(ws, dim=2).permute(3, 2, 0, 1).contiguous()
        t.update(timed(lambda: torch.nn.functional.conv2d(x_lib, w_lib,
                                                          padding=1),
                       "library_"))
        del x_lib
        torch.cuda.empty_cache()
        flops = 2 * n_bd * H * W * 128 * 128 * 9 * nin
        nbytes = (nin + 1) * n_bd * H * W * 128 * 2 + nin * 9 * 128 * 128 * 2 \
            + 2 * n_bd * 128 * 4
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM * 1e3
        times[key] = dict(
            **t, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            l2="cold", library_call="F.conv2d alone (cuDNN), no stats")
        log_conv_time(f"{key} N={n_bd}", times[key])
    del bd_in, feats, flat, ts, grads, loc, glob
    torch.cuda.empty_cache()
    # the probe's warm A/B on the same inputs (drawn from SEED): the kernel
    # with its stats consumed against cuDNN's conv + a stats pass, and
    # cuDNN's conv alone
    probe_out = probe.run(dev, seed=SEED)
    log("[probe] " + json.dumps(probe_out))
    torch.cuda.empty_cache()
    for key, t in times.items():
        extra = (f"library {t['library_ms']:.3f} ms" if t["library_ms"]
                 else f"no library call; eager {t['eager_ms']:.3f} ms "
                      f"({t['eager_call']})")
        dev_share = (f"{t['bound_ms'] / t['device_ms']:.1%}"
                     if t["device_ms"] else "not recorded")
        log(f"[time] {key}: kernel {t['ms']:.3f} ms cold L2 (profiler "
            f"device {fmt_ms(t['device_ms'], 4)}, queued {t['queued_ms']:.4f}, "
            f"warm {t['warm_ms']:.3f}), plain {t['plain_ms']:.3f} ms, "
            f"{extra}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); at "
            f"{dev_share} of the bound by device time, "
            f"{t['bound_ms'] / t['queued_ms']:.1%} queued")
    sources = {"jsd_loss_fwd": ("head.cu", "pallas_head.py:67"),
               "jsd_loss_bwd": ("head.cu", "pallas_head.py:89"),
               "minmax_complement": ("head.cu", "pallas_head.py:220"),
               "conv3x3_bd+stats": ("conv_bd.cu", "pallas_conv_bd.py:96"),
               "conv3x3_bd2in+stats": ("conv_bd.cu", "pallas_conv_bd.py:119")}
    rows = [dict(name=k, route="cuda", source=f"onet_tpu_torch/csrc/{src}",
                 replaces=f"onet_tpu/ops/{rep}", launches=launches[k],
                 max_abs_err=errs[k], **times[k])
            for k, (src, rep) in sources.items()]
    return rows


# ---------------------------------------------------------------------------
# phase 6: the simclutter workload
# ---------------------------------------------------------------------------

SIM_LEVELS = (0, 1, 2)          # SimclutterConfig's low_snr..high_snr
SIM_FRAMES = 150                # its frames_per_level
SIM_CROP = 224                  # its input_sz (400^2 frames cropped)
SIM_BASE = 64                   # its base_channels
SIM_EPOCHS = 3                  # of its 301: the one cut
SIM_BATCH = 10                  # its batch_sz


def sim_stats(raw, levels) -> dict:
    """Per level: mean peak PSNR and region SNR (metrics.psnr_snr) over
    the frames with a target pixel; the mask fraction."""
    from onet_tpu_torch.metrics.segmentation import psnr_snr

    out = {"mask_fraction": float(raw["labels"].mean())}
    for lvl in levels:
        sel = raw["psnr"] == lvl
        f, m = raw["imgs"][sel][..., 0], raw["labels"][sel]
        keep = m.sum(dim=(1, 2)) > 0
        vals = torch.stack([torch.stack(psnr_snr(a, b))
                            for a, b in zip(f[keep], m[keep])])
        peak, region = vals.mean(0).tolist()
        out[lvl] = dict(peak_psnr_db=peak, region_snr_db=region,
                        frames=int(keep.sum()))
    return out


def sim_data(dev) -> tuple:
    """Phase 6, step 1: both clutter families' default datasets generated
    on the card, twice from one seed; returns (their statistics, the first
    full batch of the Rayleigh frames)."""
    from onet_tpu_torch.core.prng import RngStream
    from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset

    data, rayleigh_x = {}, None
    for bg in ("rayleigh", "k"):
        # twice from one seed: the first call includes first-use set-up
        # (torch compiles some special functions at first use); the same
        # data both times
        secs, raws = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raws.append(generate_rayleigh_dataset(
                RngStream(SEED).next(), levels=SIM_LEVELS,
                frames_per_level=SIM_FRAMES, crop=SIM_CROP, bg=bg))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        raw = raws.pop()
        if not all(torch.equal(raw[k], raws[0][k]) for k in raw):
            raise AssertionError(f"{bg}: one seed gave two datasets")
        del raws
        n = len(SIM_LEVELS) * SIM_FRAMES
        if raw["imgs"].shape != (n, SIM_CROP, SIM_CROP, 1) or \
                raw["imgs"].device.type != dev.type:
            raise AssertionError(f"{bg} data {tuple(raw['imgs'].shape)} "
                                 f"on {raw['imgs'].device}")
        if not (torch.isfinite(raw["imgs"]).all()
                and torch.isfinite(raw["labels"]).all()):
            raise AssertionError(f"{bg} data holds NaN or inf")
        st = sim_stats(raw, SIM_LEVELS)
        st["generate_s"] = secs
        data[bg] = st
        log(f"[sim] {bg}: {n} frames of 400^2 -> {SIM_CROP}^2 generated on "
            f"the card in {secs[0]:.3f} s (first call), {secs[1]:.3f} s "
            f"(again, the same data); mask fraction "
            f"{st['mask_fraction']:.4f}; per level (peak PSNR, region SNR "
            "dB): " + ", ".join(
                f"{lvl}: {st[lvl]['peak_psnr_db']:.3f}, "
                f"{st[lvl]['region_snr_db']:.3f}" for lvl in SIM_LEVELS))
        if not 0.005 < st["mask_fraction"] < 0.5:
            raise AssertionError(f"{bg} mask fraction {st['mask_fraction']}")
        region = [st[lvl]["region_snr_db"] for lvl in SIM_LEVELS]
        if region != sorted(region) or len(set(region)) != len(region):
            raise AssertionError(f"{bg} region SNR does not rise: {region}")
        for lvl in SIM_LEVELS:
            checked_db = [st[lvl]["region_snr_db"]]
            if bg == "rayleigh":
                checked_db.append(st[lvl]["peak_psnr_db"])
            if not all(lvl - 1.0 < v < lvl + 12.0 for v in checked_db):
                raise AssertionError(f"{bg} level {lvl}: {st[lvl]} outside "
                                     f"({lvl - 1}, {lvl + 12}) dB")
        if bg == "rayleigh":
            rayleigh_x = raw["imgs"][:SIM_BATCH].clone()
        del raw
        torch.cuda.empty_cache()
    return data, rayleigh_x


def drive(TC, res) -> dict:
    """Phase 6, steps 2 and 3: train() for SIM_EPOCHS epochs, the launches
    of the pair-packed kernels counted around the call (the eval calls'
    apart) and asserted; then train(resume=True) one epoch further.
    Returns the epoch marks (perf_counter seconds) read around the
    driver's own calls; the driver itself is not changed for the
    measurement."""
    import glob
    import os
    import tempfile

    from onet_tpu_torch.core.bridge import load_onet_npz
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.data.arrays import num_batches
    from onet_tpu_torch.models.unet import tree_leaves, tree_map
    from onet_tpu_torch.train import simclutter as SC

    counted = {"conv3x3_wp": TC.conv3x3_wp_raw,
               "conv3x3_wp2": TC.conv3x3_wp2_raw,
               "conv3x3_wp_dw": TC.conv3x3_wp_dw}

    def counts():
        c = {k: f.launches for k, f in counted.items()}
        c["conv3x3_wp+stats"] = TC.conv3x3_wp_raw.stats_launches
        c["conv3x3_wp2+stats"] = TC.conv3x3_wp2_raw.stats_launches
        return c

    marks = {"train": [], "eval": [], "eval_end": []}
    eval_launches = {k: 0 for k in counts()}
    real_eval, real_iter = SC.evaluate, SC.batch_iterator

    def timed_eval(*a, **kw):
        torch.cuda.synchronize()
        marks["eval"].append(time.perf_counter())
        before = counts()
        out = real_eval(*a, **kw)
        torch.cuda.synchronize()
        marks["eval_end"].append(time.perf_counter())
        for k, v in counts().items():
            eval_launches[k] += v - before[k]
        return out

    def marked_iter(ds, batch_size, *, gen=None, **kw):
        if gen is not None:                # the train loop's, once an epoch
            torch.cuda.synchronize()
            marks["train"].append(time.perf_counter())
            res["n_train"] = len(ds)
        return real_iter(ds, batch_size, gen=gen, **kw)

    out_root = tempfile.mkdtemp(prefix="onet_simclutter_")
    cfg = dict(eval_every=1, save_epochs=(), out_root=out_root,
               input_sz=SIM_CROP, frames_per_level=SIM_FRAMES,
               base_channels=SIM_BASE)
    SC.evaluate, SC.batch_iterator = timed_eval, marked_iter
    try:
        for f in counted.values():
            f.launches = 0
        TC.conv3x3_wp_raw.stats_launches = 0
        TC.conv3x3_wp2_raw.stats_launches = 0
        t0 = time.perf_counter()
        params, _, hist = SC.train(SC.SimclutterConfig(
            epoch_nums=SIM_EPOCHS, **cfg), policy=BF16_COMPUTE, log=False)
        train_s = time.perf_counter() - t0
        total = counts()
    finally:
        SC.evaluate, SC.batch_iterator = real_eval, real_iter
    n_train = res["n_train"]
    steps = SIM_EPOCHS * num_batches(n_train, SIM_BATCH)
    launches = {k: total[k] - eval_launches[k] for k in total}
    want = {k: v * steps for k, v in PER_STEP.items()}
    want.update({"conv3x3_wp+stats": 2 * steps, "conv3x3_wp2+stats": steps})
    log(f"[sim] train(): {n_train} training frames, {steps} steps in "
        f"{SIM_EPOCHS} epochs, {train_s:.2f} s; step launches {launches}; "
        f"eval launches ({len(marks['eval'])} evaluate calls) "
        f"{eval_launches}; losses {hist['loss']}; eval {hist['eval']}")
    if launches != want:
        raise AssertionError(f"driver launches {launches}, expected {want}")
    if eval_launches["conv3x3_wp_dw"] or not eval_launches["conv3x3_wp"]:
        raise AssertionError(f"eval launches {eval_launches}")
    if not all(np.isfinite(hist["loss"])) or \
            sorted(hist["eval"]) != list(range(SIM_EPOCHS)) or not all(
                0.0 <= v <= 1.0 for m in hist["eval"].values()
                for v in m.values()):
        raise AssertionError(f"driver history off: {hist}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError("non-finite parameter after train()")

    # resume: the milestone of the last epoch, back through the bridge
    saved = glob.glob(os.path.join(
        out_root, f"onet_rayleigh_epoch_{SIM_EPOCHS - 1}_*.npz"))
    if len(saved) != 1:
        raise AssertionError(f"milestones {os.listdir(out_root)}")
    file_params, _, file_epoch = load_onet_npz(saved[0])
    same = lambda a, b: all(torch.equal(x, y) for x, y in  # noqa: E731
                            zip(tree_leaves(a), tree_leaves(b)))
    if file_epoch != SIM_EPOCHS - 1 or not same(file_params, params):
        raise AssertionError("the saved milestone is not the trained state")
    loaded = {}
    real_load = SC.load_checkpoint

    def capture(*a, **kw):
        got = real_load(*a, **kw)
        loaded.update(params=tree_map(torch.clone, got[0]), epoch=got[2])
        return got

    SC.load_checkpoint = capture
    try:
        t0 = time.perf_counter()
        _, _, hist2 = SC.train(SC.SimclutterConfig(
            epoch_nums=SIM_EPOCHS + 1, resume=True, **cfg),
            policy=BF16_COMPUTE, log=False)
        resume_s = time.perf_counter() - t0
    finally:
        SC.load_checkpoint = real_load
    log(f"[sim] resume: loaded epoch {loaded.get('epoch')}, ran epochs "
        f"{sorted(hist2['eval'])} in {resume_s:.2f} s, loss {hist2['loss']}")
    if loaded.get("epoch") != SIM_EPOCHS - 1 or \
            sorted(hist2["eval"]) != [SIM_EPOCHS] or \
            len(hist2["loss"]) != 1 or not same(loaded["params"],
                                                file_params):
        raise AssertionError("resume did not continue from the saved epoch")
    shutil.rmtree(out_root)
    res.update(train_s=train_s, resume_s=resume_s, launches=launches,
               eval_launches=eval_launches)
    return marks


def step_operands(TC, run) -> list:
    """The operands of every kernel launch that ``run()`` makes, copied as
    it gives them to the kernels: ("conv", xs, taps, bias, bias_relu,
    stats, out_dtype) for each conv_wp launch, ("dw", x, dy) for each
    conv_wp_dw launch. The launches themselves run unchanged."""
    ops = []
    real_launch, real_dw = TC._launch, TC._launch_dw

    def launch(xs, taps, *rest):
        ops.append(("conv", [x.clone() for x in xs],
                    [t.clone() for t in taps], *rest))
        return real_launch(xs, taps, *rest)

    def launch_dw(x, dy):
        ops.append(("dw", x.clone(), dy.clone()))
        return real_dw(x, dy)

    TC._launch, TC._launch_dw = launch, launch_dw
    try:
        run()
        torch.cuda.synchronize()
    finally:
        TC._launch, TC._launch_dw = real_launch, real_dw
    return ops


def check_step_kernels(TC, ops, tag) -> dict:
    """Every captured launch of one train step against its plain version
    on the same operands, at conv_err's and dw_err's tolerances (the
    stats, dw within SUM_REL of their largest magnitude; y within one bf16
    rounding); raises on a disagreement. The step must have made
    PER_STEP's launches: its forward convs carry the stats epilogue, the
    others are the input-gradient (dx) convs. Returns the largest absolute
    error of each kind."""
    errs, seen = {}, {}
    for op in ops:
        if op[0] == "dw":
            _, x, dy = op
            key = "conv3x3_wp_dw"
            err = dw_err(TC, x, dy, f"{key} {tag} N={x.shape[0]}")
        else:
            _, xs, taps, bias, bias_relu, stats, _ = op
            name = "conv3x3_wp" if len(xs) == 1 else "conv3x3_wp2"
            key = name + ("+stats" if stats else "+dx")
            ws = [TC.make_wc_we(t, dtype=t.dtype) for t in taps]
            err = conv_err(TC, name, xs, ws, bias,
                           f"{key} {tag} N={xs[0].shape[0]}",
                           bias_relu=bias_relu, stats=stats)
        errs[key] = max(errs.get(key, 0.0), err)
        seen[key] = seen.get(key, 0) + 1
    want = {"conv3x3_wp+stats": 2, "conv3x3_wp+dx": 4, "conv3x3_wp2+stats": 1,
            "conv3x3_wp_dw": PER_STEP["conv3x3_wp_dw"]}
    if seen != want:
        raise AssertionError(f"{tag}: launches {seen}, expected {want}")
    return errs


def simclutter_workload(TC, dev) -> dict:
    """Phase 6: the simclutter workload through its driver at full width
    (base 64, 224^2 crops of 400^2 frames, batch 10, bf16, pair-packed;
    SimclutterConfig's defaults). The one cut: epoch_nums, 3 of 301 (and 4
    for the resume), since 301 epochs do not fit a smoke run.

    1. Both clutter families' default datasets (levels 0-2 x 150 frames)
       generated on the card, twice from one seed (the same data): wall
       time of each, mask fraction, peak PSNR and
       region SNR per level. Checked: finite, mask fraction in (0.005,
       0.5), the region SNR rising with the level and inside (level - 1,
       level + 12) dB, the Rayleigh peak PSNR inside that band (the bands
       tests/test_simulators.py holds the JAX package to). The peak PSNR
       is printed, not ordered: at 0-2 dB the clutter under the mask sets
       it, flat in both packages.
    2. train() for 3 epochs on its own Rayleigh data, the launches of the
       three pair-packed kernels counted around the call, the eval calls'
       apart; asserted against the steps times phase 4's per-step counts.
    3. train(resume=True) to epoch 4: starts at epoch 3 from the saved
       file, whose params (read through core/bridge.load_onet_npz) equal
       the first run's and the loaded ones.
    4. The kernels at the driver's shapes: one train step on the first
       full batch of the Rayleigh frames (N=20 packed samples) and one on
       its ragged slice (the last batch's 5 frames, N=10), every launch's
       operands captured and the kernel held against its plain version on
       them; each step's loss against the stacked step's from the same
       start (1e-2 relative, as phase 4).
    5. Times: each epoch's train and eval wall time, the driver's
       frames/s, the step alone at the same shapes (CUDA events, median of
       5 after 2 warm-ups), its profile, and the host share 1 - steps'
       time / epoch's train time."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train import simclutter as SC
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    if SC.SimclutterConfig.batch_sz != SIM_BATCH:
        raise AssertionError("SimclutterConfig's batch is not SIM_BATCH")
    res = {}
    res["data"], rayleigh_x = sim_data(dev)
    lr = SC.SimclutterConfig.base_lr
    with pair_pack(O, True):
        marks = drive(TC, res)
        torch.cuda.empty_cache()
        n_train = res["n_train"]
        rag = n_train % SIM_BATCH
        p0, st0 = O.onet_init(torch.Generator().manual_seed(SEED + 60), 1,
                              base=SIM_BASE)
        step = make_train_step(policy=BF16_COMPUTE)
        with pair_pack(O, False):
            step_st = make_train_step(policy=BF16_COMPUTE)
        res["kernel_errs"], res["bf16_loss_rel"] = {}, []
        for x in (rayleigh_x, rayleigh_x[:rag]) if rag else (rayleigh_x,):
            tag = f"in the driver's step, batch {x.shape[0]}"
            got = {}
            ops = step_operands(TC, lambda: got.update(loss=step(
                _clone(p0), _clone(st0), adam_init(p0), x, lr)[3]))
            for k, e in check_step_kernels(TC, ops, tag).items():
                res["kernel_errs"][k] = max(res["kernel_errs"].get(k, 0.0), e)
            del ops
            torch.cuda.empty_cache()
            with pair_pack(O, False):
                loss_st = step_st(_clone(p0), _clone(st0), adam_init(p0), x,
                                  lr)[3].item()
            loss = got["loss"].item()
            rel = abs(loss_st - loss) / abs(loss)
            res["bf16_loss_rel"].append(rel)
            log(f"[sim] first-step loss {tag}: wp {loss:.6f}, stacked "
                f"{loss_st:.6f}, relative difference {rel:.3e}")
            if not rel <= 1e-2:
                raise AssertionError(f"{tag}: wp/stacked loss differ by {rel}")

        # the step alone at the driver's shapes: full batches and the
        # ragged one
        o0 = adam_init(p0)
        step_ms = cuda_ms(lambda: step(p0, st0, o0, rayleigh_x, lr))
        rag_ms = cuda_ms(lambda: step(p0, st0, o0, rayleigh_x[:rag], lr)) \
            if rag else 0.0
        steps_ms = (n_train // SIM_BATCH) * step_ms + rag_ms
        breakdown(lambda: step(p0, st0, o0, rayleigh_x, lr),
                  f"train step {SIM_CROP}^2 batch {SIM_BATCH} wp", top=8)
    epochs = []
    for e in range(SIM_EPOCHS):
        tr = (marks["eval"][e] - marks["train"][e]) * 1e3
        ev = (marks["eval_end"][e] - marks["eval"][e]) * 1e3
        epochs.append(dict(train_ms=tr, eval_ms=ev,
                           frames_per_s=n_train / tr * 1e3,
                           host_share=1.0 - steps_ms / tr))
    res.update(epochs=epochs, step_ms=step_ms, ragged_step_ms=rag_ms,
               step_frames_per_s=SIM_BATCH / step_ms * 1e3)
    for e, ep in enumerate(epochs):
        log(f"[sim] epoch {e}: train {ep['train_ms']:.1f} ms "
            f"({ep['frames_per_s']:.1f} frames/s, host share "
            f"{ep['host_share']:.3f}), eval {ep['eval_ms']:.1f} ms")
    log(f"[sim] step alone, batch {SIM_BATCH} at {SIM_CROP}^2 bf16 "
        f"pair-packed: {step_ms:.3f} ms ({SIM_BATCH / step_ms * 1e3:.1f} "
        f"frames/s); ragged batch of {rag}: {rag_ms:.3f} ms; an epoch's "
        f"steps {steps_ms:.1f} ms")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card", file=sys.stderr)
        return 2
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.ops import _build
    from onet_tpu_torch.ops import conv_wp as TC

    dev = resolve_device()
    card = card_line()
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); nvidia-smi name, "
        f"power.limit:")
    log(card)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas_report(_build, "conv_wp", no_spill="conv_wp_bf16")
    ptxas_report(_build, "conv_wp_dw", no_spill="dw_bf16")
    ptxas_report(_build, "conv_bd", no_spill="conv_bd")
    ptxas_report(_build, "head", no_spill="minmax_cluster")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels(TC, dev)
    check_train_kernels(TC, dev)
    times = time_kernels(TC, dev)
    torch.cuda.empty_cache()
    train_times, train_errs = time_train_kernels(TC, dev)
    times.update(train_times)
    errs.update(train_errs)
    torch.cuda.empty_cache()
    served = serve(TC, dev)
    log("[serve] " + json.dumps(served))
    log(f"[serve] 512x512 batch 8, bf16, pair-packed: "
        f"{served['b8_wp_frames_per_s']:.1f} frames/s, step p50 "
        f"{served['b8_wp_step_ms']:.2f} ms, HTTP request p50 "
        f"{served['http_request_ms_p50']:.2f} ms on {card}")
    torch.cuda.empty_cache()
    trained = train(TC, dev)
    log("[train] " + json.dumps(trained))
    log(f"[train] 512x512 batch 8, bf16, Adam: pair-packed "
        f"{trained['train_b8_wp_frames_per_s']:.1f} frames/s, stacked "
        f"{trained['train_b8_stacked_frames_per_s']:.1f} frames/s on {card}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase5_rows = head_minmax_bd(dev)
    log(f"[phase5] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sim = simclutter_workload(TC, dev)
    log("[sim] " + json.dumps(sim))
    steady = sim["epochs"][1:] or sim["epochs"]
    log(f"[sim] simclutter driver, {SIM_CROP}x{SIM_CROP} batch 10 bf16 "
        f"pair-packed: {np.median([e['frames_per_s'] for e in steady]):.1f} "
        f"frames/s over epochs 1-{SIM_EPOCHS - 1}, host share "
        f"{np.median([e['host_share'] for e in steady]):.3f}; the step "
        f"alone {sim['step_frames_per_s']:.1f} frames/s; on {card}")
    log(f"[phase6] phase took {time.perf_counter() - t0:.1f} s")

    rows = []
    for name, meta in KERNELS.items():
        rows.append(dict(
            name=name, route="cuda", source="onet_tpu_torch/csrc/conv_wp.cu",
            replaces=meta["replaces"], launches=served["launches"][name],
            max_abs_err=errs[name], max_err=errs[name], **times[name]))
    for name, meta in KERNELS.items():
        key = name + "+stats"
        rows.append(dict(
            name=key, route="cuda", source="onet_tpu_torch/csrc/conv_wp.cu",
            replaces=meta["replaces"], launches=trained["launches"][key],
            max_abs_err=errs[key], **times[key]))
    stats_launches = trained["launches"]["conv3x3_wp+stats"]
    rows.append(dict(
        name="conv3x3_wp+dx", route="cuda",
        source="onet_tpu_torch/csrc/conv_wp.cu",
        replaces=KERNELS["conv3x3_wp"]["replaces"],
        launches=trained["launches"]["conv3x3_wp"] - stats_launches,
        max_abs_err=errs["conv3x3_wp+dx"], **times["conv3x3_wp+dx"]))
    rows.append(dict(
        name="conv3x3_wp_dw", route="cuda",
        source="onet_tpu_torch/csrc/conv_wp_dw.cu",
        replaces="onet_tpu/ops/pallas_conv.py:457",
        launches=trained["launches"]["conv3x3_wp_dw"],
        max_abs_err=errs["conv3x3_wp_dw"], **times["conv3x3_wp_dw"]))
    # the same kernels' launches in phase 6's train() (the eval calls'
    # apart), beside the phase-4 counts in "launches", and their largest
    # errors at the driver's shapes (N=20 and N=10 at 224^2)
    sl = sim["launches"]
    sim_launches = {"conv3x3_wp+stats": sl["conv3x3_wp+stats"],
                    "conv3x3_wp2+stats": sl["conv3x3_wp2+stats"],
                    "conv3x3_wp+dx": sl["conv3x3_wp"] - sl["conv3x3_wp+stats"],
                    "conv3x3_wp_dw": sl["conv3x3_wp_dw"]}
    for row in rows:
        if row["name"] in sim_launches:
            row["simclutter_launches"] = sim_launches[row["name"]]
            row["simclutter_max_abs_err"] = sim["kernel_errs"][row["name"]]
    rows += phase5_rows
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
