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
  7. sweeps, detectors, transfer (``detection_workload``), on phase 6's
     checkpoints at full width, bf16, pair-packed, each step's launches
     counted and held to its eval forwards x 3 (plus its train steps'):
     the per-PSNR checkpoint sweep (levels 0-10 x 150 frames at 224^2,
     batch 10), the FAR-budget detector (one 150-frame forward per level,
     N=300, and roc_points on 7,526,400 pixels; against its CPU run), NAU
     rain transfer on 10 synthetic 200^2 frames at batch 5 beside the
     CA-CFAR baseline (against its CPU run), train_by_snr (levels 0 and
     10, 1 epoch each) and the two-stage Onet; the four figures' inputs
     under runs/chip_smoke_phase7 (``render_figures`` draws them where
     matplotlib is installed); every conv launch of one eval forward at
     N=10 (200^2), N=20 and N=300 (224^2) against its plain version.
  8. the ZY-3 cloud-detection workload (``zy3_workload``) at full width
     (base 64, 224^2 RGB, batch 5, bf16, pair-packed, aug on):
     synthesize_zy3's 250 train and 50 test scenes made on the card, three
     epochs of train/zy3.py's train() with the kernels' launches asserted
     (steps x 6/1/4, eval forwards x 2/1/0), a restart_from to epoch 4;
     every kernel launch of one augmented step (N=10), one eval forward
     (N=10) and one oracle-scoring forward (N=18) against its plain
     version; the report's rows with the detector rows and its workbook
     (under runs/chip_smoke_phase8); dehaze and the nine preprocessing
     options on the test thumbnails equal to their CPU runs;
     choose_best_preprocess on 5; generation, step, augmentation, epoch,
     eval and dehaze times, the host share and the peak memory.
  9. the serving and data surfaces (``serving_surfaces``) at full width
     (phase 3's model, bf16, pair-packed, tile 512, halo 32, batch 8):
     POST /segment?scene=1 through the daemon with a 2000x3000 scene (24
     windows of 576^2, 3 batches), again with normalize=1, and a 300x420
     scene (one padded window), each request's launches asserted (6/3,
     6/3, 2/1) and its mask equal to a direct infer_tiled call; every
     launch of one window batch (N=16) against its plain version; tiled
     against whole-scene masks (>= 0.97); a 2048^2 RGB scene at
     in_channels=3 (launches 4/2); the request p50, megapixels/s and the
     idle share of one tiled scene. The base-64 bf16 folded graph exported
     as a single-file artifact (symbolic batch), loaded afresh on the card
     and served over HTTP (8, 8, 8 and 5 frames): masks >= 0.999 and S
     within one bf16 rounding of the live stacked step, no hand-written
     kernel launched, a corrupted copy refused, its step timed beside the
     live ones. Phase 6's last checkpoint out through
     export_torch_checkpoint and back, bit-equal, serving equal masks. A
     dataset of phase 6's shape generated on the card, written as the
     reference's .pt and as a tile store, read back bit-equal, the store's
     open, zero-copy load and host->card copy timed against torch.load;
     verify_dataset on the .pt with its base-64 eval on the card. Files
     under runs/chip_smoke_phase9, removed at the end.
 10. int8 (``int8_workload``) at full width: phase 6's run resumed to 20
     epochs (phase 6's own checkpoint is too young for the 0.99 contract;
     its agreement is reported beside), calibrated on 16 frames of a
     fresh simclutter train split; mask agreement with the bf16 folded
     graph on its test split (fatal under 0.99, printed against 0.999)
     and on 512^2 frames; launches a batch asserted (16 + 4 with the bf16
     head, 18 + 4 without); every int8 launch of a batch-8 step held on a
     batch-1 slice against its plain version (int32 sums and int8 codes
     bit-equal); each site's kernel timed beside its bound, cuDNN's bf16
     conv (``torch._int_mm`` for the transposed conv) and, at two sites,
     the plain version; the int8 steps at batch 8 and 32 beside the bf16
     steps; int8 over HTTP (batch 8) and as an artifact exported on the
     card (its launches counted, its S equal to the live step's); 5 train
     steps each of exact, "fwd" and "fwd+dx" at 512^2 batch 8 from phase
     4's init (18 and 35 launches a step, step-5 loss within 0.08); one
     simclutter epoch with quantized="fwd+dx" (35 launches a step).
 11. the other model families and the baselines (``families_workload``)
     at full width, bf16 (the baselines float32), none of the hand-written
     kernels launched (all ten counters asserted unchanged): Swin-T,
     ConvNeXt-T and ViT-B TransUNet twins through the ZY-3 driver with
     arch= (phase 8's data and defaults, one epoch each), each reloaded
     through load_arch_auto bit-equal, each step alone at phase 8's and
     phase 6's shapes (ms, frames/s, idle share, peak memory); Swin
     through the simclutter driver (one epoch at its defaults) and
     verify_checkpoint_dir over its checkpoint and phase 6's vanilla one
     (levels 0, 5, 10 x 150 frames); a 512^2 batch-8 forward per backbone
     (Swin window 8, TransUNet's position table resized 14 -> 32); IIC
     and InfoSeg, one epoch each of their train() at their defaults;
     every family's card float32 forward on 2 frames against its CPU
     float32 forward (atol 2e-5, rtol 1e-4, fatal).
 12. parallel training over torch.distributed (``parallel_workload``): (a)
     an NCCL world of one rank in this process, the data-parallel train
     and eval steps on mesh (1, 1) at phase 4's shape (bf16, batch 8,
     512^2, pair-packed and stacked) bit-equal to the plain steps, the
     pair-packed step's launches asserted equal to STEP_LAUNCHES a step and
     the eval's to EVAL_LAUNCHES, its step time beside phase 4's; (b) a
     gloo world of 4 spawned processes sharing the card (NCCL refuses two
     ranks on one device): data parallel (2, 1), spatial (1, 2) and
     (1, 2, 2), channel (1, 2) and pipeline (1, 2) with M = 2, float32 at
     512^2, base 64, 2 frames a data shard, each against the plain step on
     the global batch on the card and every rank's trees bit-equal; times
     there are not multi-GPU numbers; (c) with two or more cards, (b)'s
     cases over NCCL on min(4, count) cards and the data-parallel frames/s
     summed over ranks.
 13. the command line (``cli_workload``, ``onet_tpu_torch/run.py`` in this
     process, pair-packed, bf16): (a) ``run reproduce --scale smoke`` (the
     eight stages at base 64, 224^2, NAU 200^2, ZY-3 scenes 384^2), each
     stage's seconds and its launches held to its steps x 6/1/4 and
     unfolded forwards x 2/1/0 (``reproduce_expect``), both reports read
     back; (b) ``run summary`` on the card equal to its CPU run, 31.04 M
     parameters; (c) ``run serve --http 0 --http-requests 3`` on (a)'s
     newest simclutter checkpoint, 8 frames at 512^2 a request, masks equal
     to a direct ``onet_infer``, launches 2/1 a request; ``export-artifact``
     then ``serve`` of the artifact, one request, equal to its own call;
     (d) ``utils/profiling``: ``trace`` + ``category_breakdown`` of phase
     4's pair-packed step, the elementwise share, ``StepTimer`` beside
     phase 4's CUDA-event time; (e) ``bench`` and ``simclutter --dp 2``
     exit with their messages.
The second-to-last line is the kernels JSON, the last the result JSON.
Exits non-zero without a CUDA device or without the port beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import queue
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile

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
              tries: int = 3, host: bool = True) -> dict:
    """Device time by kernel over one call, from torch.profiler; the wall
    time includes the profiler's own cost. Short spin kernels before and
    after the call (left out of the sums) keep its records off both ends
    of the trace. With ``kernels``, the launches one call makes, a profile
    that missed some is taken again, up to ``tries`` times; the log line
    says if it stays short. ``host=False`` traces the card's activity
    only. Returns the wall and busy ms, the idle share and the kernel
    count."""
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
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernels": count}


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
                "head_bwd", "minmax_cluster", "conv_i8")


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


def serving_model(dev, in_channels: int = 1, seed: int = SEED) -> tuple:
    """The served Onet: base 64, seeded weights, and non-trivial running
    statistics drawn from the same generator, so folding is exercised."""
    from onet_tpu_torch.models.onet import onet_init

    gen = torch.Generator().manual_seed(seed)
    params, state = onet_init(gen, in_channels, base=64, device=dev)

    def perturb(tree):
        if "var" in tree:
            c = tree["var"].shape
            return {"mean": (0.1 * torch.randn(c, generator=gen)).to(dev),
                    "var": (0.5 + torch.rand(c, generator=gen)).to(dev)}
        return {k: perturb(v) for k, v in tree.items()}

    return params, perturb(state)


def serve(TC, dev) -> dict:
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.unet import param_count
    from onet_tpu_torch.serve.http import ServingSession, start_server

    params, state = serving_model(dev)
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


def launch_counts(TC) -> dict:
    """The pair-packed kernels' launch counters: conv3x3_wp, conv3x3_wp2,
    conv3x3_wp_dw, and the two convs' launches with the stats epilogue."""
    return {"conv3x3_wp": TC.conv3x3_wp_raw.launches,
            "conv3x3_wp2": TC.conv3x3_wp2_raw.launches,
            "conv3x3_wp_dw": TC.conv3x3_wp_dw.launches,
            "conv3x3_wp+stats": TC.conv3x3_wp_raw.stats_launches,
            "conv3x3_wp2+stats": TC.conv3x3_wp2_raw.stats_launches}


def reset_counts(TC) -> None:
    for f in (TC.conv3x3_wp_raw, TC.conv3x3_wp2_raw, TC.conv3x3_wp_dw):
        f.launches = 0
    TC.conv3x3_wp_raw.stats_launches = 0
    TC.conv3x3_wp2_raw.stats_launches = 0


def drive(TC, res) -> dict:
    """Phase 6, steps 2 and 3: train() for SIM_EPOCHS epochs, the launches
    of the pair-packed kernels counted around the call (the eval calls'
    apart) and asserted; then train(resume=True) one epoch further. The
    checkpoint directory (res["out_root"]) is left for phase 7.
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

    marks = {"train": [], "eval": [], "eval_end": []}
    eval_launches = {k: 0 for k in launch_counts(TC)}
    real_eval, real_iter = SC.evaluate, SC.batch_iterator

    def timed_eval(*a, **kw):
        torch.cuda.synchronize()
        marks["eval"].append(time.perf_counter())
        before = launch_counts(TC)
        out = real_eval(*a, **kw)
        torch.cuda.synchronize()
        marks["eval_end"].append(time.perf_counter())
        for k, v in launch_counts(TC).items():
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
        reset_counts(TC)
        t0 = time.perf_counter()
        params, _, hist = SC.train(SC.SimclutterConfig(
            epoch_nums=SIM_EPOCHS, **cfg), policy=BF16_COMPUTE, log=False)
        train_s = time.perf_counter() - t0
        total = launch_counts(TC)
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
    res.update(train_s=train_s, resume_s=resume_s, launches=launches,
               eval_launches=eval_launches, out_root=out_root)
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


STEP_LAUNCHES = {"conv3x3_wp+stats": 2, "conv3x3_wp+dx": 4,
                 "conv3x3_wp2+stats": 1,
                 "conv3x3_wp_dw": PER_STEP["conv3x3_wp_dw"]}
EVAL_LAUNCHES = {"conv3x3_wp+stats": 2, "conv3x3_wp2+stats": 1}


def check_step_kernels(TC, ops, tag, want=STEP_LAUNCHES) -> dict:
    """Every captured launch of one train step (or, with ``want`` =
    EVAL_LAUNCHES, one eval forward) against its plain version on the same
    operands, at conv_err's and dw_err's tolerances (the stats, dw within
    SUM_REL of their largest magnitude; y within one bf16 rounding);
    raises on a disagreement. The call must have made ``want``'s launches:
    the forward convs carry the stats epilogue, the others are the
    input-gradient (dx) convs. Returns the largest absolute error of each
    kind."""
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


# ---------------------------------------------------------------------------
# phase 7: per-PSNR sweeps, the ROC and CA-CFAR detectors, NAU transfer and
# the two-stage Onet
# ---------------------------------------------------------------------------

DET_LEVELS = tuple(range(0, 11))  # per_snr_datasets' levels
DET_FRAMES = 150                  # its frames_per_level (224^2 crops)
DET_BATCH = 10                    # verify_checkpoint_dir's and test_by_snr's
FAR_BUDGETS = (1e-3, 1e-2, 5e-2, 1e-1)
NAU_FRAMES = 10                   # synthesize_nau_rain's n
NAU_SIZE = 200                    # its size, the radar frames' 200x200
NAU_BATCH = 5                     # test_naurain's batch (the naurain config)
CFAR_KVAL = 2.0
STAGE_LEVELS = (0, 10)            # stage 1 trained at 0 dB, stage 2 at 10
STAGE_EPOCHS = 1                  # of SimclutterConfig's 301: the one cut
FIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "runs", "chip_smoke_phase7")
FIGURES = ("nau_rain_transfer", "nau_method_comparison",
           *(f"two_stage_level{lvl:02d}" for lvl in STAGE_LEVELS))


def save_figure_inputs(name: str, fn: str, **arrays) -> None:
    """The arguments of report/curves.py's ``fn`` for figure ``name``,
    saved to FIG_DIR/<name>.npz. The card's host has no matplotlib, so
    phase 7 keeps what each figure shows and ``render_figures`` draws them
    where matplotlib is installed."""
    np.savez(os.path.join(FIG_DIR, name + ".npz"), fn=fn, **arrays)


def render_figures(fig_dir: str = FIG_DIR) -> list:
    """Draw phase 7's figures (<name>.png beside each <name>.npz) with
    report/curves.py:

        python3 -c "import chip_smoke; chip_smoke.render_figures()"
    """
    import glob

    from onet_tpu_torch.report import curves

    out = []
    for npz in sorted(glob.glob(os.path.join(fig_dir, "*.npz"))):
        with np.load(npz) as z:
            kw = {k: z[k] for k in z.files}
        fn = str(kw.pop("fn"))
        if fn == "save_method_comparison_grid":
            names = kw.pop("method_names").tolist()
            kw["methods"] = dict(zip(names, kw.pop("method_preds")))
            kw["fars"] = dict(zip(names, kw.pop("method_fars").tolist()))
        for k in ("names", "title"):
            if k in kw:
                kw[k] = kw[k].tolist()
        out.append(getattr(curves, fn)(npz[:-4] + ".png", **kw))
    return out


def expect(forwards: int, steps: int = 0) -> dict:
    """The launches of ``forwards`` eval forwards (3 stats-epilogue convs
    each) and ``steps`` train steps (PER_STEP each) on the pair-packed
    path, as launch_counts reports them."""
    return {"conv3x3_wp": 2 * forwards + PER_STEP["conv3x3_wp"] * steps,
            "conv3x3_wp2": forwards + PER_STEP["conv3x3_wp2"] * steps,
            "conv3x3_wp_dw": PER_STEP["conv3x3_wp_dw"] * steps,
            "conv3x3_wp+stats": 2 * forwards + 2 * steps,
            "conv3x3_wp2+stats": forwards + steps}


def run_step(TC, res, name, fn, frames, forwards, steps=0):
    """Run phase 7's step ``name``: counts from 0, wall time around it
    (synchronized), frames/s; the launches must equal ``expect(forwards,
    steps)``. Returns fn's result."""
    torch.cuda.synchronize()
    reset_counts(TC)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts(TC)
    want = expect(forwards, steps)
    res["steps"][name] = dict(wall_s=wall, frames=frames,
                              frames_per_s=frames / wall, launches=got)
    log(f"[detect] {name}: {wall:.3f} s, {frames} frames, "
        f"{frames / wall:.1f} frames/s; launches {got}")
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return out


def check_metrics(tag, m: dict) -> None:
    bad = {k: v for k, v in m.items() if not 0.0 <= v <= 1.0}
    if bad:
        raise AssertionError(f"{tag}: metrics outside [0, 1]: {bad}")


def roc_card_vs_cpu(score, labels, tag) -> dict:
    """roc_points on the card against its run on the CPU on the same
    inputs: thresholds within 2 float32 ulps (only float64 log/pow may
    round apart), far and dr equal wherever no score lies within 2 ulps of
    a threshold. Returns the counts."""
    from onet_tpu_torch.metrics.roc import roc_points

    got = [t.cpu() for t in roc_points(score, labels, 512)]
    ref = roc_points(score.cpu(), labels.cpu(), 512)
    bits = lambda t: t.view(torch.int32).long()  # noqa: E731
    ulps = (bits(got[2]) - bits(ref[2])).abs()
    srt = torch.sort(score.reshape(-1).float().cpu()).values
    i = torch.searchsorted(srt, ref[2]).clamp(1, srt.numel() - 1)
    near = torch.minimum((bits(srt[i]) - bits(ref[2])).abs(),
                         (bits(srt[i - 1]) - bits(ref[2])).abs()) <= 2
    same = all(torch.equal(g[~near], r[~near])
               for g, r in zip(got[:2], ref[:2]))
    out = dict(max_ulps=int(ulps.max()), near=int(near.sum()))
    log(f"[check] roc_points {tag}, card vs CPU: thresholds within "
        f"{out['max_ulps']} ulps, far/dr {'equal' if same else 'DIFFER'} "
        f"({out['near']} thresholds within 2 ulps of a score)")
    if out["max_ulps"] > 2 or not same:
        raise AssertionError(f"roc_points {tag}: card and CPU disagree")
    return out


def cfar_card_vs_cpu(imgs, det) -> dict:
    """cfar_seg_batch on the card against its run on the CPU on the same
    frames: masks equal except at pixels within 1e-5 * kval * bg of the
    decision (bg in float64), where the two cumsums' orders may differ."""
    from onet_tpu_torch.metrics import cfar as CF

    ref = CF.cfar_seg_batch(imgs.cpu(), CFAR_KVAL)
    x = imgs[..., 0].double().cpu()
    ii = CF._integral(x)
    (rs, rc), (gs, gc) = (CF._window_sums(ii, x.shape[1], x.shape[2], r)
                          for r in (16, 8))
    bg = (rs - gs) / torch.clamp_min(rc - gc, 1)
    near = (x - CFAR_KVAL * bg).abs() <= 1e-5 * CFAR_KVAL * bg
    differ = det.cpu() != ref
    out = dict(differ=int(differ.sum()), near=int(near.sum()))
    log(f"[check] cfar_seg_batch {tuple(imgs.shape)}, card vs CPU: "
        f"{out['differ']} pixels differ, {out['near']} within rounding of "
        "the decision")
    if bool((differ & ~near).any()):
        raise AssertionError("cfar_seg_batch: card and CPU disagree")
    return out


def detection_workload(TC, dev, ckpt_dir: str) -> dict:
    """Phase 7: Queue A item 2 at full width (base 64, bf16, pair-packed),
    each step's launches counted from 0 and asserted:

    1. per_snr_datasets (levels 0-10 x 150 frames, 400^2 -> 224^2, on the
       card); verify_checkpoint_dir on phase 6's checkpoints at batch 10:
       the per-level acc/mIoU/dr/far/tIoU and the ave row.
    2. threshold_sweep_by_snr at the FAR budgets (one forward of 150
       frames, N=300 packed, per level): achieved far and dr per level and
       budget, peak device memory, the ROC's time per level; roc_points on
       the card against its CPU run on the last level.
    3. synthesize_nau_rain (10 frames of 200^2) on the card; test_naurain
       at batch 5 with phase 6's model and its figure; cfar_seg_batch
       (kval 2.0) on the same frames, its metrics, its CPU run; the method
       comparison figure.
    4. train_by_snr for levels 0 and 10, 1 epoch each (the one cut);
       verify_two_stage (stage 1 the level-0 model, stage 2 the level-10
       one) over levels 0 and 10; the two-stage eval on one batch of
       each. The four figures' inputs (NAU transfer, method comparison,
       two-stage at levels 0 and 10) go to FIG_DIR as .npz.
    5. Every conv launch of one eval forward at each new shape (N=10 at
       200^2, N=20 and N=300 at 224^2) against its plain version.
    Times: each step's wall time and frames/s."""
    import glob
    import tempfile

    from onet_tpu_torch.core.checkpoint import load_onet_npz
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.core.prng import RngStream
    from onet_tpu_torch.data.arrays import num_batches
    from onet_tpu_torch.data.nau import synthesize_nau_rain
    from onet_tpu_torch.metrics.cfar import cfar_seg_batch
    from onet_tpu_torch.metrics.segmentation import (
        evaluate_binary_segmentation)
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train import nau as TN
    from onet_tpu_torch.train import simclutter as SC
    from onet_tpu_torch.train import sweeps as SW
    from onet_tpu_torch.train import two_stage as TS
    from onet_tpu_torch.train.steps import make_eval_step

    pol = BF16_COMPUTE
    res = {"steps": {}, "t_start": time.time()}
    os.makedirs(FIG_DIR, exist_ok=True)
    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.npz")))
    params, bn, _ = load_onet_npz(files[-1])      # the resumed run's
    host = TS.to_host

    # step 1: the checkpoint sweep
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = SW.per_snr_datasets(SEED, levels=DET_LEVELS,
                               frames_per_level=DET_FRAMES, crop=SIM_CROP)
    torch.cuda.synchronize()
    res["datasets_s"] = time.perf_counter() - t0
    n_frames = sum(len(ds) for ds in data.values())
    log(f"[detect] per_snr_datasets: {n_frames} frames in "
        f"{res['datasets_s']:.3f} s")
    batches = sum(num_batches(len(ds), DET_BATCH) for ds in data.values())
    rep = run_step(
        TC, res, "checkpoint_sweep", lambda: SW.verify_checkpoint_dir(
            ckpt_dir, datasets_by_psnr=data, batch_sz=DET_BATCH, policy=pol),
        len(files) * n_frames, len(files) * batches)
    if list(rep) != [os.path.basename(f) for f in files]:
        raise AssertionError(f"swept {list(rep)}, files {files}")
    for f, r in rep.items():
        log(f"[detect] {f} (epoch {r['epoch']}, {r['arch']}): level acc "
            "miou dr far tiou")
        for lvl, m in r["per_snr"].items():
            check_metrics(f"{f} level {lvl}", m)
            log(f"[detect]   {lvl:>3}: " + " ".join(
                f"{m[k]:.4f}" for k in TS.KEYS))
    res["checkpoint_sweep"] = {f: {"epoch": r["epoch"],
                                   "ave": r["per_snr"]["ave"]}
                               for f, r in rep.items()}

    # step 2: the FAR-budget detector, one forward per level
    roc_ms, last = [], {}
    real_roc = SW.dr_at_far

    def timed_roc(score, labels, budgets):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_roc(score, labels, budgets)       # ends in a host read
        roc_ms.append((time.perf_counter() - t) * 1e3)
        last.update(score=score, labels=labels)
        return out

    SW.dr_at_far = timed_roc
    torch.cuda.reset_peak_memory_stats()
    try:
        sweep = run_step(TC, res, "threshold_sweep",
                         lambda: SW.threshold_sweep_by_snr(
                             params, bn, data, far_budgets=FAR_BUDGETS,
                             policy=pol), n_frames, len(data))
    finally:
        SW.dr_at_far = real_roc
    res["threshold_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["roc_ms"] = roc_ms
    log(f"[detect] FAR-budget detection (achieved far / dr per budget "
        f"{FAR_BUDGETS}); argmax dr / far; peak "
        f"{res['threshold_peak_gib']:.2f} GiB; ROC of {SIM_CROP}^2 x "
        f"{DET_FRAMES} = {DET_FRAMES * SIM_CROP ** 2} pixels per level: "
        f"{np.median(roc_ms):.2f} ms median ({min(roc_ms):.2f}-"
        f"{max(roc_ms):.2f})")
    for lvl, r in sweep.items():
        th = r["thresh"]
        log(f"[detect]   {lvl:>3}: " + "  ".join(
            f"{th[b]['far']:.2e}/{th[b]['dr']:.4f}" for b in FAR_BUDGETS)
            + f"  argmax {r['argmax']['dr']:.4f}/{r['argmax']['far']:.4f}")
        drs = [th[b]["dr"] for b in FAR_BUDGETS if not np.isnan(th[b]["dr"])]
        if any(th[b]["far"] > b for b in FAR_BUDGETS) or \
                drs != sorted(drs) or not drs:
            raise AssertionError(f"level {lvl}: FAR budgets broken: {r}")
    res["threshold_sweep"] = sweep
    res["roc_card_vs_cpu"] = roc_card_vs_cpu(last["score"], last["labels"],
                                             f"level {DET_LEVELS[-1]}")
    del last

    # step 3: NAU transfer and the CA-CFAR baseline
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nau, ids = synthesize_nau_rain(RngStream(SEED + 70).next(),
                                   n=NAU_FRAMES, size=NAU_SIZE)
    torch.cuda.synchronize()
    res["nau_synth_s"] = time.perf_counter() - t0
    res["nau_mask_fraction"] = float(nau["labels"].mean())
    x, lab = nau["imgs"], nau["labels"]
    if x.shape != (NAU_FRAMES, NAU_SIZE, NAU_SIZE, 1) or \
            not bool(torch.isfinite(x).all()) or \
            abs(res["nau_mask_fraction"] - 0.25) > 0.01:
        raise AssertionError(f"NAU frames {tuple(x.shape)}, mask fraction "
                             f"{res['nau_mask_fraction']}")
    ev_nau = TN.make_transfer_eval(policy=pol)

    def transfer():
        out = TN.test_naurain(params, bn, nau, batch_sz=NAU_BATCH,
                              policy=pol, ids=ids)
        return out, ev_nau(params, bn, x[:NAU_BATCH], lab[:NAU_BATCH])

    nau_out, (_, _, onet_pred, (vt, vd)) = run_step(
        TC, res, "nau_transfer", transfer, NAU_FRAMES,
        num_batches(NAU_FRAMES, NAU_BATCH) + 1)
    check_metrics("test_naurain", {k: nau_out[k] for k in TS.KEYS})
    if not all(np.isfinite(v) for v in nau_out.values()):
        raise AssertionError(f"test_naurain: {nau_out}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det = cfar_seg_batch(x, CFAR_KVAL)
    cfar_m = {k: float(v) for k, v in
              evaluate_binary_segmentation(det, lab).items()}
    res["cfar_ms"] = (time.perf_counter() - t0) * 1e3
    check_metrics("CA-CFAR", cfar_m)
    res["cfar_card_vs_cpu"] = cfar_card_vs_cpu(x, det)
    onet_far = float(evaluate_binary_segmentation(
        onet_pred, lab[:NAU_BATCH])["far"])
    first = (host(x[:NAU_BATCH]), host(lab[:NAU_BATCH]))
    save_figure_inputs(          # test_naurain's figure, its first batch
        "nau_rain_transfer", "save_nau_rain_grid", x=first[0],
        names=np.array(ids[:NAU_BATCH]), pred_t=host(vt), pred_d=host(vd),
        label=first[1], pred=host(onet_pred), title="nau_rain_transfer")
    save_figure_inputs(
        "nau_method_comparison", "save_method_comparison_grid", x=first[0],
        label=first[1], method_names=np.array(["Onet", "CA-CFAR"]),
        method_preds=np.stack([host(onet_pred), host(det[:NAU_BATCH])]),
        method_fars=np.array([onet_far, cfar_m["far"]]))
    res.update(nau=nau_out, cfar=cfar_m)
    log(f"[detect] NAU transfer ({NAU_FRAMES} synthetic rain frames of "
        f"{NAU_SIZE}^2, mask fraction {res['nau_mask_fraction']:.4f}, made "
        f"in {res['nau_synth_s']:.3f} s): " + " ".join(
            f"{k} {v:.4f}" for k, v in nau_out.items()))
    log(f"[detect] CA-CFAR kval {CFAR_KVAL} on the same frames "
        f"({res['cfar_ms']:.2f} ms): " + " ".join(
            f"{k} {v:.4f}" for k, v in cfar_m.items()))

    # step 4: the two-stage Onet
    stage_root = tempfile.mkdtemp(prefix="onet_two_stage_")
    base = SC.SimclutterConfig(epoch_nums=STAGE_EPOCHS, save_epochs=(),
                               out_root=stage_root, input_sz=SIM_CROP,
                               frames_per_level=DET_FRAMES)
    n_train = int(base.frames_per_level * 0.9)
    steps = STAGE_EPOCHS * num_batches(n_train, base.batch_sz)
    evals = num_batches(base.frames_per_level - n_train, base.batch_sz)
    trained = run_step(
        TC, res, "train_by_snr",
        lambda: SW.train_by_snr(base, levels=STAGE_LEVELS, policy=pol),
        len(STAGE_LEVELS) * STAGE_EPOCHS * n_train,
        len(STAGE_LEVELS) * evals, len(STAGE_LEVELS) * steps)
    shutil.rmtree(stage_root)
    for lvl, (p_l, _, hist) in trained.items():
        if not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"train_by_snr level {lvl}: {hist}")
        log(f"[detect] train_by_snr level {lvl}: loss {hist['loss']}, "
            f"eval {hist['eval']}")
    (p1, b1, _), (p2, b2, _) = (trained[lvl] for lvl in STAGE_LEVELS)
    pair = {lvl: data[lvl] for lvl in STAGE_LEVELS}
    two = run_step(TC, res, "verify_two_stage", lambda: TS.verify_two_stage(
        p1, b1, p2, b2, pair, batch_sz=DET_BATCH, policy=pol),
        2 * sum(len(ds) for ds in pair.values()),
        2 * sum(num_batches(len(ds), DET_BATCH) for ds in pair.values()))
    for lvl, r in two.items():
        for stage, m in r.items():
            check_metrics(f"two-stage {lvl} {stage}", m)
        log(f"[detect] two-stage {lvl}: " + "; ".join(
            f"{stage} " + " ".join(f"{k} {m[k]:.4f}" for k in TS.KEYS)
            for stage, m in r.items()))
    ev2 = TS.make_two_stage_eval(policy=pol)
    batches = {lvl: {k: v[:DET_BATCH] for k, v in pair[lvl].data.items()}
               for lvl in STAGE_LEVELS}
    outs = run_step(TC, res, "two_stage_batches", lambda: {
        lvl: ev2(p1, b1, p2, b2, b["imgs"], b["labels"])
        for lvl, b in batches.items()},
        len(STAGE_LEVELS) * DET_BATCH, 2 * len(STAGE_LEVELS))
    for lvl, (_, _, pred1, pred2, (x2, fg)) in outs.items():
        save_figure_inputs(      # draw_two_stage's figure
            f"two_stage_level{lvl:02d}", "save_two_stage_grid",
            x1=host(batches[lvl]["imgs"]), x2=host(x2),
            fg=host(fg[..., None]), label=host(batches[lvl]["labels"]),
            label1=host(pred1), label2=host(pred2),
            title=f"two_stage_level{lvl:02d}")
    res["two_stage"] = two
    figs = [os.path.join(FIG_DIR, f + ".npz") for f in FIGURES]
    log(f"[detect] figure inputs (drawn by render_figures where matplotlib "
        f"is installed): {figs}")
    if not all(os.path.getmtime(f) >= res["t_start"] for f in figs):
        raise AssertionError(f"figure inputs not written by this run: {figs}")
    del outs
    res["launches"] = {k: sum(st["launches"][k]
                              for st in res["steps"].values())
                       for k in launch_counts(TC)}
    del trained, p1, b1, p2, b2
    torch.cuda.empty_cache()

    # step 5: every conv launch of one eval forward at the new shapes
    ev = make_eval_step(policy=pol)

    def forward_all(x):
        with torch.no_grad(), pol.precision():
            O.onet_forward(params, bn, x, train=False, policy=pol)

    errs = {}
    for tag, run in (
            (f"NAU {NAU_SIZE}^2 batch {NAU_BATCH}",
             lambda: ev_nau(params, bn, x[:NAU_BATCH], lab[:NAU_BATCH])),
            (f"sweep {SIM_CROP}^2 batch {DET_BATCH}",
             lambda: ev(params, bn, data[10]["imgs"][:DET_BATCH],
                        data[10]["labels"][:DET_BATCH])),
            (f"threshold sweep {SIM_CROP}^2 level of {DET_FRAMES}",
             lambda: forward_all(data[10]["imgs"]))):
        ops = step_operands(TC, run)
        for k, e in check_step_kernels(TC, ops, f"in the eval of the {tag}",
                                       want=EVAL_LAUNCHES).items():
            errs[k] = max(errs.get(k, 0.0), e)
        del ops
        torch.cuda.empty_cache()
    res["kernel_errs"] = errs
    return res


# ---------------------------------------------------------------------------
# phase 8: the ZY-3 cloud-detection workload
# ---------------------------------------------------------------------------

ZY3_TRAIN, ZY3_TEST = 250, 50     # the reference's ZY-3 train and test dicts
ZY3_SIZE = 224                    # their 224^2 RGB thumbnails
ZY3_COVER = 0.35                  # synthesize_zy3's cloud_cover
ZY3_EPOCHS = 3                    # of Zy3Config's 11: the one cut
ZY3_CHOOSE = 5                    # test thumbnails through the oracle choice
ZY3_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "runs", "chip_smoke_phase8")
# The card's host has pandas and PIL (checked there with `python3 -c
# "import pandas, PIL"`: pandas 3.0.2, PIL 12.2.0), so phase 8 writes the
# Excel report there; it has no matplotlib, so phase 8 draws no figure.


def zy3_data(dev) -> tuple:
    """Phase 8, step 1: the train and test scenes generated on the card
    (synthesize_zy3 at the reference's sizes). Returns (train, test, test
    ids, wall seconds)."""
    from onet_tpu_torch.core.prng import RngStream
    from onet_tpu_torch.data.zy3 import synthesize_zy3

    stream = RngStream(SEED + 80)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_ds, _ = synthesize_zy3(stream.next(), n=ZY3_TRAIN, size=ZY3_SIZE,
                                 cloud_cover=ZY3_COVER)
    test_ds, test_ids = synthesize_zy3(stream.next(), n=ZY3_TEST,
                                       size=ZY3_SIZE, cloud_cover=ZY3_COVER)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name, ds, n in (("train", train_ds, ZY3_TRAIN),
                        ("test", test_ds, ZY3_TEST)):
        x, m = ds["imgs"], ds["labels"]
        cover = float(m.mean())
        if x.shape != (n, ZY3_SIZE, ZY3_SIZE, 3) or x.device.type != dev.type \
                or not bool(torch.isfinite(x).all()) \
                or abs(cover - ZY3_COVER) > 0.01:
            raise AssertionError(f"zy3 {name} scenes {tuple(x.shape)} on "
                                 f"{x.device}, cloud cover {cover}")
    log(f"[zy3] generation: {ZY3_TRAIN} + {ZY3_TEST} RGB scenes of "
        f"{ZY3_SIZE}^2 on the card in {secs:.3f} s; cloud cover "
        f"{float(train_ds['labels'].mean()):.4f} / "
        f"{float(test_ds['labels'].mean()):.4f}")
    return train_ds, test_ds, test_ids, secs


def zy3_drive(TC, res, train_ds, test_ds) -> dict:
    """Phase 8, step 2: train() for ZY3_EPOCHS epochs with Zy3Config's
    defaults, the pair-packed kernels' launches counted around the call and
    around its evaluate_zy3 calls; then restart_from its milestone to one
    epoch more. Returns the epoch marks (perf_counter seconds)."""
    import glob
    import tempfile

    from onet_tpu_torch.core.bridge import load_onet_npz
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.data.arrays import num_batches
    from onet_tpu_torch.models.unet import tree_leaves
    from onet_tpu_torch.train import zy3 as Z

    marks = {"train": [], "eval": [], "eval_end": []}
    eval_launches = {k: 0 for k in launch_counts(TC)}
    real_eval, real_iter = Z.evaluate_zy3, Z.batch_iterator

    def timed_eval(*a, **kw):
        torch.cuda.synchronize()
        marks["eval"].append(time.perf_counter())
        before = launch_counts(TC)
        out = real_eval(*a, **kw)
        torch.cuda.synchronize()
        marks["eval_end"].append(time.perf_counter())
        for k, v in launch_counts(TC).items():
            eval_launches[k] += v - before[k]
        return out

    def marked_iter(ds, batch_size, *, gen=None, **kw):
        if gen is not None:                # the train loop's, once an epoch
            torch.cuda.synchronize()
            marks["train"].append(time.perf_counter())
        return real_iter(ds, batch_size, gen=gen, **kw)

    out_root = tempfile.mkdtemp(prefix="onet_zy3_")
    cfg = dict(save_epochs=(), out_root=out_root)
    Z.evaluate_zy3, Z.batch_iterator = timed_eval, marked_iter
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(TC)
        t0 = time.perf_counter()
        params, bn, hist = Z.train(Z.Zy3Config(epoch_nums=ZY3_EPOCHS, **cfg),
                                   train_ds, test_ds, policy=BF16_COMPUTE,
                                   log=False)
        torch.cuda.synchronize()
        res["train_s"] = time.perf_counter() - t0
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        total = launch_counts(TC)
    finally:
        Z.evaluate_zy3, Z.batch_iterator = real_eval, real_iter
    batch = Z.Zy3Config.batch_sz
    steps = ZY3_EPOCHS * num_batches(ZY3_TRAIN, batch)
    forwards = ZY3_EPOCHS * num_batches(ZY3_TEST, batch)
    launches = {k: total[k] - eval_launches[k] for k in total}
    log(f"[zy3] train(): {ZY3_TRAIN} scenes, {steps} steps in {ZY3_EPOCHS} "
        f"epochs, {res['train_s']:.2f} s; step launches {launches}; eval "
        f"launches ({len(marks['eval'])} evaluate_zy3 calls, {forwards} "
        f"forwards) {eval_launches}; losses {hist['loss']}; eval "
        f"{hist['eval']}")
    want = expect(0, steps)
    if launches != want:
        raise AssertionError(f"driver launches {launches}, expected {want}")
    if eval_launches != expect(forwards):
        raise AssertionError(f"eval launches {eval_launches}, expected "
                             f"{expect(forwards)}")
    if not all(np.isfinite(hist["loss"])) or \
            sorted(hist["eval"]) != list(range(ZY3_EPOCHS)) or not all(
                0.0 <= m[k] <= 1.0 for m in hist["eval"].values()
                for k in ("acc", "miou", "dr", "far", "tiou")):
        raise AssertionError(f"driver history off: {hist}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError("non-finite parameter after train()")

    saved = glob.glob(os.path.join(
        out_root, f"onet_vanilla_zy3_epoch{ZY3_EPOCHS - 1}_*.npz"))
    if len(saved) != 1:
        raise AssertionError(f"milestones {os.listdir(out_root)}")
    file_params, _, file_epoch = load_onet_npz(saved[0])
    if file_epoch != ZY3_EPOCHS - 1 or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(file_params),
                                              tree_leaves(params))):
        raise AssertionError("the saved milestone is not the trained state")
    t0 = time.perf_counter()
    _, _, hist2 = Z.train(Z.Zy3Config(epoch_nums=ZY3_EPOCHS + 1,
                                      restart_from=saved[0], **cfg),
                          train_ds, test_ds, policy=BF16_COMPUTE, log=False)
    res["restart_s"] = time.perf_counter() - t0
    log(f"[zy3] restart_from epoch {file_epoch}: ran epochs "
        f"{sorted(hist2['eval'])} in {res['restart_s']:.2f} s, loss "
        f"{hist2['loss']}, eval {hist2['eval']}")
    if sorted(hist2["eval"]) != [ZY3_EPOCHS] or len(hist2["loss"]) != 1 \
            or not np.isfinite(hist2["loss"][0]):
        raise AssertionError("restart_from did not continue the epoch count")
    shutil.rmtree(out_root)
    res.update(launches=launches, eval_launches=eval_launches, steps=steps,
               eval_forwards=forwards, history=hist)
    return marks, params, bn


def zy3_report(TC, res, params, bn, test_ds, test_ids) -> None:
    """Phase 8, step 3a: the report's rows on the trained model over the
    test scenes (10 eval forwards, counted), then its workbook."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.data.arrays import num_batches
    from onet_tpu_torch.train import zy3 as Z

    forwards = num_batches(ZY3_TEST, Z.Zy3Config.batch_sz)
    torch.cuda.synchronize()
    reset_counts(TC)
    t0 = time.perf_counter()
    rows, summary = Z.zy3_test_rows(params, bn, test_ds, test_ids,
                                    policy=BF16_COMPUTE)
    torch.cuda.synchronize()
    res["report_rows_s"] = time.perf_counter() - t0
    got = launch_counts(TC)
    if got != expect(forwards):
        raise AssertionError(f"report launches {got}, expected "
                             f"{expect(forwards)}")
    det = [r for r in summary if r["group"].startswith("detector@")]
    overall = next(r for r in summary if r["group"] == "all")
    if len(rows) != ZY3_TEST or len(det) != len(Z.DETECTOR_FARS) or \
            not all(np.isfinite([r["dr"], r["far"], r["threshold"]]).all()
                    and r["far"] <= float(r["group"].split("<=")[1])
                    for r in det) or \
            not 0.0 <= overall["acc"] <= 1.0 or \
            not all(r[k].shape[:2] == (ZY3_SIZE, ZY3_SIZE) for r in rows
                    for k in ("rgb", "label", "pred", "vt", "vd")):
        raise AssertionError(f"report rows {len(rows)}, summary {summary}")
    os.makedirs(ZY3_DIR, exist_ok=True)
    t0 = time.perf_counter()
    path, _ = Z.write_zy3_report(os.path.join(ZY3_DIR, "zy3_report.xlsx"),
                                 rows, summary)
    res["report_write_s"] = time.perf_counter() - t0
    with zipfile.ZipFile(path) as z:
        pngs = sum(n.endswith(".png") for n in z.namelist())
    if pngs != 5 * ZY3_TEST:
        raise AssertionError(f"{path}: {pngs} thumbnails")
    log(f"[zy3] Excel report {path}: {len(rows)} rows, {pngs} thumbnails, "
        f"written on the card's host in {res['report_write_s']:.2f} s")
    res.update(report_overall=overall, report_detector=det,
               report_launches=got)
    log(f"[zy3] report on {ZY3_TEST} test scenes ({res['report_rows_s']:.2f} "
        f"s): overall acc {overall['acc']:.4f} miou {overall['miou']:.4f}; "
        + "; ".join(f"{r['group']}: dr {r['dr']:.4f} far {r['far']:.4f} "
                    f"threshold {r['threshold']:.4f}" for r in det))


def zy3_preprocess(TC, res, params, bn, test_ds) -> None:
    """Phase 8, step 3b: dehaze and the nine preprocessing options on the
    test thumbnails, on the card against their CPU runs (equal: each step
    is elementwise, exact or a true division); dehaze's time;
    choose_best_preprocess on ZY3_CHOOSE of them (one forward of the nine
    variants each, counted)."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.preprocess.curation import choose_best_preprocess
    from onet_tpu_torch.preprocess.haze import dehaze
    from onet_tpu_torch.preprocess.image import PRE_OPTIONS, apply_pre_option

    u8 = (test_ds["imgs"] * 255).to(torch.uint8)
    im = u8.float() / 255.0
    pairs = [(f"dehaze {k}", a, b) for k, a, b in
             zip("JK", dehaze(im), dehaze(im.cpu()))]
    pairs += [(o, apply_pre_option(u8, o), apply_pre_option(u8.cpu(), o))
              for o in PRE_OPTIONS]
    res["card_vs_cpu_differ"] = {tag: int((a.cpu() != b).sum())
                                 for tag, a, b in pairs}
    log(f"[check] dehaze and the nine preprocessing options on {ZY3_TEST} "
        f"thumbnails {tuple(im.shape)}, card vs CPU, values that differ: "
        f"{res['card_vs_cpu_differ']}")
    if any(res["card_vs_cpu_differ"].values()):
        raise AssertionError("preprocessing: card and CPU disagree")
    res["dehaze_ms_per_frame"] = cuda_ms(lambda: dehaze(im)) / ZY3_TEST
    torch.cuda.synchronize()
    reset_counts(TC)
    t0 = time.perf_counter()
    best, rows = choose_best_preprocess(
        params, bn, list(u8[:ZY3_CHOOSE]), list(test_ds["labels"][:ZY3_CHOOSE]),
        [f"zy3_syn_{i:04d}" for i in range(ZY3_CHOOSE)], policy=BF16_COMPUTE)
    torch.cuda.synchronize()
    res["choose_s"] = time.perf_counter() - t0
    got = launch_counts(TC)
    if got != expect(ZY3_CHOOSE):
        raise AssertionError(f"choose launches {got}, expected "
                             f"{expect(ZY3_CHOOSE)}")
    if len(rows) != ZY3_CHOOSE * len(PRE_OPTIONS) or not all(
            0.0 <= r[m] <= 1.0 for r in rows for m in ("acc", "miou")):
        raise AssertionError(f"choose_best_preprocess rows {rows}")
    res["choose"] = {name: (b["option"], b["acc"], b["miou"])
                     for name, b in best.items()}
    log(f"[zy3] dehaze {res['dehaze_ms_per_frame']:.3f} ms per {ZY3_SIZE}^2 "
        f"frame (batch of {ZY3_TEST}); choose_best_preprocess on "
        f"{ZY3_CHOOSE} thumbnails x {len(PRE_OPTIONS)} options in "
        f"{res['choose_s']:.2f} s: {res['choose']}")


def zy3_workload(TC, dev) -> dict:
    """Phase 8: the ZY-3 cloud-detection workload at full width (base 64,
    224^2 RGB, batch 5, bf16, pair-packed; Zy3Config's defaults: Adam at
    1e-4, cosine warm restarts, aug on, per-image Hungarian eval every
    epoch). The one cut: epoch_nums, 3 of 11 (and a 4th through
    restart_from).

    1. synthesize_zy3 on the card: 250 train and 50 test scenes.
    2. train() for 3 epochs, the pair-packed kernels' launches asserted:
       steps x (6 / 1 / 4), and evaluate_zy3's forwards x (2 / 1 / 0);
       restart_from the milestone to epoch 4.
    3. Every kernel launch of one driver step on an augmented batch (N=10
       packed), of one eval forward (N=10) and of one oracle-scoring
       forward (nine variants, N=18) against its plain version; the step's
       loss against the stacked step's from the same start (1e-2
       relative).
    4. zy3_test_rows on the trained model over the 50 test scenes (the
       detector rows required), the workbook; dehaze and the nine
       preprocessing options on the test thumbnails equal to their CPU
       runs; choose_best_preprocess on 5 of them.
    5. Times: generation, each epoch's train and eval wall time and
       frames/s, the step alone and the augmentation alone at batch 5
       (CUDA events, median), the host share 1 - batches x (step +
       augmentation) / epoch's train time, the peak memory of train(),
       dehaze per frame."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.data.arrays import num_batches
    from onet_tpu_torch.data.augment import augment_batch
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.models.unet import param_count
    from onet_tpu_torch.preprocess.curation import score_variants
    from onet_tpu_torch.preprocess.image import PRE_OPTIONS, apply_pre_option
    from onet_tpu_torch.train import zy3 as Z
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    cfg = Z.Zy3Config()
    res = {}
    train_ds, test_ds, test_ids, res["generate_s"] = zy3_data(dev)
    marks, params, bn = zy3_drive(TC, res, train_ds, test_ds)
    res["params_m"] = param_count(params) / 1e6
    torch.cuda.empty_cache()

    # the kernels at train()'s operands: one step on an augmented batch
    lr = cfg.base_lr
    p0, st0 = O.onet_init(torch.Generator().manual_seed(SEED + 80),
                          cfg.in_channels, base=cfg.base_channels)
    x = augment_batch(make_generator(SEED + 81, dev),
                      train_ds["imgs"][:cfg.batch_sz])
    step = make_train_step(policy=BF16_COMPUTE)
    with pair_pack(O, False):
        step_st = make_train_step(policy=BF16_COMPUTE)
    got = {}
    tag = f"in the ZY-3 step, batch {cfg.batch_sz} RGB"
    ops = step_operands(TC, lambda: got.update(loss=step(
        _clone(p0), _clone(st0), adam_init(p0), x, lr)[3]))
    res["kernel_errs"] = check_step_kernels(TC, ops, tag)
    del ops
    with pair_pack(O, False):
        loss_st = step_st(_clone(p0), _clone(st0), adam_init(p0), x,
                          lr)[3].item()
    loss = got["loss"].item()
    res["bf16_loss_rel"] = abs(loss_st - loss) / abs(loss)
    log(f"[zy3] first-step loss {tag}: wp {loss:.6f}, stacked "
        f"{loss_st:.6f}, relative difference {res['bf16_loss_rel']:.3e}")
    if not res["bf16_loss_rel"] <= 1e-2:
        raise AssertionError(f"{tag}: wp/stacked loss differ by "
                             f"{res['bf16_loss_rel']}")
    ev = Z.make_zy3_eval(policy=BF16_COMPUTE)
    u8 = (test_ds["imgs"][:1] * 255).to(torch.uint8)
    stack = torch.stack([apply_pre_option(u8[0], o) for o in PRE_OPTIONS])
    for name, run in (
            (f"eval, batch {cfg.batch_sz}", lambda: ev(
                params, bn, test_ds["imgs"][:cfg.batch_sz],
                test_ds["labels"][:cfg.batch_sz])),
            (f"oracle scoring, {len(PRE_OPTIONS)} variants", lambda:
             score_variants(params, bn, stack, test_ds["labels"][0],
                            policy=BF16_COMPUTE))):
        ops = step_operands(TC, run)
        for k, e in check_step_kernels(TC, ops, f"in the ZY-3 {name}",
                                       want=EVAL_LAUNCHES).items():
            res["kernel_errs"][k] = max(res["kernel_errs"].get(k, 0.0), e)
        del ops
    torch.cuda.empty_cache()

    # the step and the augmentation alone, at batch 5
    with pair_pack(O, True):
        o0 = adam_init(p0)
        res["step_ms"] = cuda_ms(lambda: step(p0, st0, o0, x, lr))
        g = make_generator(SEED + 82, dev)
        res["aug_ms"] = cuda_ms(lambda: augment_batch(
            g, train_ds["imgs"][:cfg.batch_sz]))
        breakdown(lambda: step(p0, st0, o0, x, lr),
                  f"ZY-3 train step {ZY3_SIZE}^2 RGB batch {cfg.batch_sz} wp",
                  top=8)
        breakdown(lambda: augment_batch(g, train_ds["imgs"][:cfg.batch_sz]),
                  f"ZY-3 augmentation, batch {cfg.batch_sz}", top=6)
    del p0, st0, o0
    torch.cuda.empty_cache()

    with pair_pack(O, True):
        zy3_report(TC, res, params, bn, test_ds, test_ids)
        zy3_preprocess(TC, res, params, bn, test_ds)

    batches = num_batches(ZY3_TRAIN, cfg.batch_sz)
    busy = batches * (res["step_ms"] + res["aug_ms"])
    epochs = []
    for e in range(ZY3_EPOCHS):
        tr = (marks["eval"][e] - marks["train"][e]) * 1e3
        evm = (marks["eval_end"][e] - marks["eval"][e]) * 1e3
        epochs.append(dict(train_ms=tr, eval_ms=evm,
                           frames_per_s=ZY3_TRAIN / tr * 1e3,
                           host_share=1.0 - busy / tr))
    res["epochs"] = epochs
    for e, ep in enumerate(epochs):
        log(f"[zy3] epoch {e}: train {ep['train_ms'] / 1e3:.3f} s "
            f"({ep['frames_per_s']:.1f} frames/s, host share "
            f"{ep['host_share']:.3f}), eval {ep['eval_ms'] / 1e3:.3f} s")
    log(f"[zy3] step alone, batch {cfg.batch_sz} RGB at {ZY3_SIZE}^2 bf16 "
        f"pair-packed ({res['params_m']:.2f}M parameters): "
        f"{res['step_ms']:.3f} ms; augmentation {res['aug_ms']:.3f} ms per "
        f"batch; peak {res['peak_gib']:.2f} GiB in train()")
    del res["history"]
    return res


# ---------------------------------------------------------------------------
# phase 9: the serving and data surfaces
# ---------------------------------------------------------------------------

TILE, HALO = 512, 32               # tiled serving: 576^2 windows
SCENE_HW = (2000, 3000)            # 4 x 6 = 24 windows, 3 batches of 8
SMALL_HW = (300, 420)              # smaller than one window: padded, 1 batch
RGB_HW = 2048                      # a ZY-3-shaped RGB scene: 16 windows
SCENE_BATCH = 8                    # phase 3's serving batch
SCENE_REPEATS = 5                  # requests of the large scene for its p50
ART_REQUESTS = (8, 8, 8, 5)        # frames per request to the artifact
# launches of one window batch through the pair-packed serving step
WINDOW_LAUNCHES = {"conv3x3_wp": 2, "conv3x3_wp2": 1}
BF16_ROUNDING = 2.0 ** -8          # one bf16 rounding of a value <= 1
PHASE9_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "runs", "chip_smoke_phase9")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """A [h, w, 1] float32 scene in [0, 1]: ``frames``' clutter and
    blobs (one per 40,000 pixels) at any size."""
    rng = np.random.default_rng(seed)
    img = 0.3 + 0.1 * rng.standard_normal((h, w)).astype(np.float32)
    for _ in range(max(6, h * w // 40_000)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(8, 40)
        y0, y1 = max(int(cy - 4 * r), 0), min(int(cy + 4 * r) + 1, h)
        x0, x1 = max(int(cx - 4 * r), 0), min(int(cx + 4 * r) + 1, w)
        yy = np.arange(y0, y1, dtype=np.float32)[:, None]
        xx = np.arange(x0, x1, dtype=np.float32)[None, :]
        img[y0:y1, x0:x1] += 0.5 * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    return np.clip(img, 0, 1)[..., None]


def window_batches(h: int, w: int) -> int:
    from onet_tpu_torch.serve.tiles import _plan

    n = len(_plan(h, TILE)) * len(_plan(w, TILE))
    return -(-n // SCENE_BATCH)


def serve_counts(TC) -> dict:
    """The serving step's launch counters (launch_counts' first two)."""
    counts = launch_counts(TC)
    return {k: counts[k] for k in WINDOW_LAUNCHES}


def want_launches(h: int, w: int) -> dict:
    return {k: v * window_batches(h, w) for k, v in WINDOW_LAUNCHES.items()}


def newest_checkpoint(out_root: str) -> str:
    """The last milestone phase 6's driver saved."""
    import glob

    found = glob.glob(os.path.join(out_root, "onet_rayleigh_epoch_*.npz"))
    if not found:
        raise AssertionError(f"no milestone in {os.listdir(out_root)}")
    return max(found, key=lambda p: int(
        re.search(r"_epoch_(\d+)_", os.path.basename(p)).group(1)))


def check_window_batch(TC, step, folded, x) -> float:
    """Every launch of one window batch ([8, 576, 576, 1] -> N=16 packed
    samples) captured as the step gives it to the kernels and held to its
    plain version at conv_err's tolerances; returns the largest error."""
    ops = step_operands(TC, lambda: step(folded, x))
    seen, err = {}, 0.0
    for _, xs, taps, bias, bias_relu, stats, _ in ops:
        name = "conv3x3_wp" if len(xs) == 1 else "conv3x3_wp2"
        n, h, wp, _ = xs[0].shape
        if (n, h, 2 * wp) != (2 * SCENE_BATCH, TILE + 2 * HALO,
                              TILE + 2 * HALO) or stats:
            raise AssertionError(f"window launch {name} at {(n, h, wp)}, "
                                 f"stats={stats}")
        ws = [TC.make_wc_we(t, dtype=t.dtype) for t in taps]
        err = max(err, conv_err(TC, name, xs, ws, bias,
                                f"{name} in a window batch N={n} "
                                f"{h}x{2 * wp}", bias_relu=bias_relu))
        seen[name] = seen.get(name, 0) + 1
    if seen != WINDOW_LAUNCHES:
        raise AssertionError(f"window batch launches {seen}, expected "
                             f"{WINDOW_LAUNCHES}")
    return err


def serve_in_thread(sess):
    """Start the daemon on an ephemeral localhost port: (httpd, thread,
    url)."""
    from onet_tpu_torch.serve.http import start_server

    httpd = start_server(sess, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_server(httpd, th) -> None:
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=30)
    if th.is_alive():
        raise AssertionError("HTTP server thread did not stop")


def tiled_scenes(TC, dev, res) -> None:
    """Phase 9, step 1: POST /segment?scene=1 through the daemon (the
    2000x3000 scene, again with normalize=1, the 300x420 scene), each
    request's launches counted and asserted, its mask equal to a direct
    infer_tiled call; one window batch's launches held to their plain
    versions; tiled against whole-scene masks; the 2048^2 RGB scene
    through infer_tiled; times and the device idle share."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.data.zy3 import synthesize_zy3
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.ops.normalize import minmax_per_frame
    from onet_tpu_torch.serve.http import ServingSession
    from onet_tpu_torch.serve.tiles import _plan, infer_tiled

    folded = fold_onet(*serving_model(dev))

    def step(f, xb):
        return onet_infer(f, xb, policy=BF16_COMPUTE, pair_pack=True)

    def tiled(f, x):
        return infer_tiled(step, f, x, tile=TILE, halo=HALO,
                           batch=SCENE_BATCH, device=dev)

    win = TILE + 2 * HALO
    big = scene(*SCENE_HW, SEED + 90)
    small = scene(*SMALL_HW, SEED + 91)
    sess = ServingSession(step, folded, batch=SCENE_BATCH, in_channels=1,
                          mode="bf16", model_name=f"random-seed-{SEED}",
                          tile=TILE, halo=HALO)
    sess.warmup()
    if sess.input_hw != (win, win):
        raise AssertionError(f"warmed at {sess.input_hw}, not the window")
    big_name = "x".join(map(str, SCENE_HW))
    requests = [(big_name, big, ""),
                (big_name + " normalize=1", 3.0 + 6.0 * big, "&normalize=1"),
                ("x".join(map(str, SMALL_HW)), small, "")]
    httpd, th, url = serve_in_thread(sess)
    masks, big_ms = [], []
    res["scene_launches"] = {}
    try:
        for name, sc, query in requests:
            reset_counts(TC)
            t0 = time.perf_counter()
            masks.append(post(url + "/segment?scene=1" + query, sc))
            ms = (time.perf_counter() - t0) * 1e3
            got = serve_counts(TC)
            res["scene_launches"][name] = got
            want = want_launches(*sc.shape[:2])
            log(f"[scene] POST /segment?scene=1 {name}: {ms:.2f} ms, "
                f"launches {got}")
            if got != want:
                raise AssertionError(f"{name}: launches {got}, expected "
                                     f"{want}")
            if name == big_name:
                big_ms.append(ms)
        for _ in range(SCENE_REPEATS - 1):
            t0 = time.perf_counter()
            post(url + "/segment?scene=1", big)
            big_ms.append((time.perf_counter() - t0) * 1e3)
        stats = get_json(url + "/stats")
        health = get_json(url + "/healthz")
    finally:
        stop_server(httpd, th)
    log(f"[scene] healthz {health}; stats {stats}")
    if health["tile"] != TILE or stats["errors"]:
        raise AssertionError("healthz/stats disagree with the requests")

    with torch.inference_mode():
        big_dev = torch.from_numpy(big).to(dev)
        norm_dev = minmax_per_frame(
            torch.from_numpy(3.0 + 6.0 * big).to(dev)[None])[0]
        for (name, sc, _), m, x in zip(requests, masks,
                                       (big_dev, norm_dev, small)):
            direct = tiled(folded, x)
            if m.shape != (1, *sc.shape[:2]) or m.dtype != np.uint8 or \
                    not np.array_equal(m[0], direct.astype(np.uint8)):
                raise AssertionError(f"{name}: the daemon's mask differs "
                                     "from a direct infer_tiled call")
        # the scene's first window batch, as infer_tiled slices it
        h, w = SCENE_HW
        corners = [(min(max(y - HALO, 0), h - win),
                    min(max(x - HALO, 0), w - win))
                   for y in _plan(h, TILE) for x in _plan(w, TILE)]
        chunk = torch.stack([big_dev[y:y + win, x:x + win]
                             for y, x in corners[:SCENE_BATCH]])
        res["window_max_abs_err"] = check_window_batch(TC, step, folded,
                                                       chunk)
        res["window_batch_ms"] = cuda_ms(lambda: step(folded, chunk),
                                         reps=5, warmup=1)
        del chunk
        _, whole = step(folded, big_dev[None])
        res["tiled_vs_whole"] = float(
            (whole[0].cpu().numpy() == masks[0][0]).mean())
        del whole
        torch.cuda.empty_cache()
    log(f"[scene] tiled against whole-scene pair-packed masks, {big_name}: "
        f"agreement {res['tiled_vs_whole']:.6f} (>= 0.97); foreground "
        f"share {masks[0].mean():.4f}")
    if not res["tiled_vs_whole"] >= 0.97:
        raise AssertionError(f"tiled/whole agreement {res['tiled_vs_whole']}")

    mp = SCENE_HW[0] * SCENE_HW[1] / 1e6
    res["scene_request_ms"] = big_ms
    res["scene_request_ms_p50"] = float(np.median(big_ms))
    res["scene_mp_per_s"] = mp / res["scene_request_ms_p50"] * 1e3
    res["scene_server_ms_p50"] = stats["total_ms"]["p50"]
    res["tiled_scene_ms"] = cuda_ms(lambda: tiled(folded, big_dev), reps=5,
                                    warmup=1)
    res["tiled_scene_profile"] = breakdown(
        lambda: tiled(folded, big_dev), "tiled 2000x3000 scene, 3 window "
        "batches of 8 at 576^2, bf16 wp", top=8)
    del folded, big_dev, norm_dev
    torch.cuda.empty_cache()

    # a ZY-3-shaped RGB scene through infer_tiled at in_channels=3
    folded3 = fold_onet(*serving_model(dev, in_channels=3, seed=SEED + 3))
    ds, _ = synthesize_zy3(make_generator(SEED + 92, dev), n=1, size=RGB_HW)
    rgb = ds["imgs"][0]
    tiled(folded3, rgb)                      # first call at this shape
    reset_counts(TC)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_rgb = tiled(folded3, rgb)
    res["rgb_scene_ms"] = (time.perf_counter() - t0) * 1e3
    res["rgb_launches"] = serve_counts(TC)
    want = want_launches(RGB_HW, RGB_HW)
    log(f"[scene] {RGB_HW}^2 RGB scene through infer_tiled: "
        f"{res['rgb_scene_ms']:.2f} ms, launches {res['rgb_launches']}, "
        f"foreground share {m_rgb.mean():.4f}")
    if res["rgb_launches"] != want:
        raise AssertionError(f"RGB launches {res['rgb_launches']}, "
                             f"expected {want}")
    if m_rgb.shape != (RGB_HW, RGB_HW) or not set(np.unique(m_rgb)) <= {0, 1}:
        raise AssertionError(f"RGB mask {m_rgb.shape}")
    del folded3, ds, rgb
    torch.cuda.empty_cache()


def artifact_serving(TC, dev, res) -> None:
    """Phase 9, step 2: the base-64 folded bf16 graph at 512^2 exported
    with a symbolic batch, loaded afresh on the card and served over HTTP
    (3 requests of 8 frames, one of 5); its masks and S against the live
    stacked step; a corrupted copy refused; its step timed beside the live
    ones."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.serve.artifact import (export_serving_artifact,
                                               load_serving_artifact)
    from onet_tpu_torch.serve.http import ServingSession

    params, state = serving_model(dev)
    folded = fold_onet(params, state)
    path = os.path.join(PHASE9_DIR, "onet_base64_512_bf16.onetp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = export_serving_artifact(params, state, path, input_hw=(H, W),
                                   policy=BF16_COMPUTE)
    res["artifact_export_s"] = time.perf_counter() - t0
    res["artifact_bytes"] = os.path.getsize(path)
    del params, state
    t0 = time.perf_counter()
    call, meta_read = load_serving_artifact(path)
    res["artifact_load_s"] = time.perf_counter() - t0
    log(f"[artifact] exported in {res['artifact_export_s']:.2f} s, "
        f"{res['artifact_bytes']} bytes, loaded in "
        f"{res['artifact_load_s']:.2f} s; header {meta_read}")
    if meta_read != meta or meta["batch"] != "symbolic" or \
            meta["device"] != dev.type or meta["arithmetic"] != "bfloat16":
        raise AssertionError(f"artifact header {meta_read}")

    sess = ServingSession(lambda _, xb: call(xb), None, batch=SCENE_BATCH,
                          in_channels=1, mode="bf16-artifact",
                          model_name=os.path.basename(path), input_hw=(H, W))
    sess.warmup()
    reqs = [frames(n, SEED + 100 + i) for i, n in enumerate(ART_REQUESTS)]
    httpd, th, url = serve_in_thread(sess)
    try:
        reset_counts(TC)
        masks = [post(url + "/segment", r) for r in reqs]
        launches = serve_counts(TC)
        stats = get_json(url + "/stats")
    finally:
        stop_server(httpd, th)
    if any(launches.values()):
        raise AssertionError(f"the artifact launched {launches}: it is the "
                             "stacked graph")
    if stats["requests"] != len(reqs) or stats["frames"] != sum(ART_REQUESTS):
        raise AssertionError(f"stats {stats}")
    agree, s_err = [], 0.0
    with torch.inference_mode():
        for r, m in zip(reqs, masks):
            n = r.shape[0]
            x = torch.from_numpy(np.concatenate(
                [r] + [r[-1:]] * (SCENE_BATCH - n))).to(dev)
            s_art, l_art = call(x)
            s_live, l_live = onet_infer(folded, x, policy=BF16_COMPUTE,
                                        pair_pack=False)
            if m.shape != (n, H, W) or not np.array_equal(
                    m, l_art[:n].cpu().numpy().astype(np.uint8)):
                raise AssertionError("HTTP masks differ from the artifact")
            agree.append(float((l_art[:n] == l_live[:n]).float().mean()))
            s_err = max(s_err, (s_art - s_live).abs().max().item())
    res["artifact_agreement"] = min(agree)
    res["artifact_s_max_abs_err"] = s_err
    log(f"[artifact] {len(reqs)} requests of {list(ART_REQUESTS)} frames: "
        f"masks agree with the live stacked step on {agree}, max |S_art - "
        f"S_live| {s_err:.3e}; stats {stats}")
    if min(agree) < 0.999 or not s_err <= BF16_ROUNDING:
        raise AssertionError("the artifact disagrees with the live step")

    bad = path + ".corrupt"
    data = bytearray(open(path, "rb").read())
    data[-100] ^= 0xFF
    with open(bad, "wb") as f:
        f.write(bytes(data))
    del data
    try:
        load_serving_artifact(bad)
    except ValueError as e:
        if "checksum" not in str(e):
            raise
        log(f"[artifact] a copy with one flipped byte: {e}")
    else:
        raise AssertionError("a corrupted artifact loaded")

    x8 = torch.from_numpy(reqs[0]).to(dev)
    res["artifact_step_ms"] = cuda_ms(lambda: call(x8), reps=5, warmup=2)
    res["live_stacked_step_ms"] = cuda_ms(lambda: onet_infer(
        folded, x8, policy=BF16_COMPUTE, pair_pack=False), reps=5, warmup=2)
    res["live_wp_step_ms"] = cuda_ms(lambda: onet_infer(
        folded, x8, policy=BF16_COMPUTE, pair_pack=True), reps=5, warmup=2)
    log(f"[artifact] batch 8 at 512^2 bf16: artifact "
        f"{res['artifact_step_ms']:.3f} ms, live stacked "
        f"{res['live_stacked_step_ms']:.3f} ms, live pair-packed "
        f"{res['live_wp_step_ms']:.3f} ms")
    del call, folded, x8
    torch.cuda.empty_cache()


def bridge_round_trip(dev, res, ckpt: str) -> None:
    """Phase 9, step 3: phase 6's trained checkpoint out to the reference's
    schema and back, bit for bit, and the masks both serve equal."""
    from onet_tpu_torch.core.bridge import (export_torch_checkpoint,
                                            import_torch_checkpoint,
                                            load_onet_npz)
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.unet import tree_leaves

    params, state, epoch = load_onet_npz(ckpt)
    pt = os.path.join(PHASE9_DIR, "onet_phase6.pytorch")
    t0 = time.perf_counter()
    export_torch_checkpoint(pt, params, state, epoch)
    res["bridge_export_s"] = time.perf_counter() - t0
    p2, s2, e2 = import_torch_checkpoint(pt)
    same = all(torch.equal(a, b) for a, b in zip(
        [*tree_leaves(params), *tree_leaves(state)],
        [*tree_leaves(p2), *tree_leaves(s2)]))
    x = torch.from_numpy(frames(SCENE_BATCH, SEED + 110)).to(dev)
    with torch.inference_mode():
        l1 = onet_infer(fold_onet(params, state), x, policy=BF16_COMPUTE,
                        pair_pack=True)[1]
        l2 = onet_infer(fold_onet(p2, s2), x, policy=BF16_COMPUTE,
                        pair_pack=True)[1]
    res["bridge_bit_equal"] = same and e2 == epoch
    res["bridge_masks_equal"] = bool(torch.equal(l1, l2))
    log(f"[bridge] {os.path.basename(ckpt)} (epoch {epoch}) -> "
        f"{os.path.getsize(pt)} bytes in {res['bridge_export_s']:.2f} s -> "
        f"back: bit-equal {res['bridge_bit_equal']}, served masks equal "
        f"{res['bridge_masks_equal']}")
    if not (res["bridge_bit_equal"] and res["bridge_masks_equal"]):
        raise AssertionError("the bridge round trip changed the model")


def data_files(dev, res) -> None:
    """Phase 9, step 4: a dataset of phase 6's shape generated on the card,
    written as the reference's .pt and as a tile store, both read back
    bit-equal; the store's open, zero-copy load and host->card copy timed
    against torch.load; verify_dataset on the .pt with its base-64 eval on
    the card."""
    from onet_tpu_torch.core.prng import RngStream
    from onet_tpu_torch.data.export import export_simclutter_pt
    from onet_tpu_torch.data.tilestore import (load_store, native_available,
                                               save_store)
    from onet_tpu_torch.data.verify import format_report, verify_dataset
    from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset

    if not native_available():
        raise AssertionError("the native tile store did not build")
    ds = generate_rayleigh_dataset(RngStream(SEED + 120).next(),
                                   levels=SIM_LEVELS,
                                   frames_per_level=SIM_FRAMES, crop=SIM_CROP)
    pt = os.path.join(PHASE9_DIR, "rayleigh.pt")
    store = os.path.join(PHASE9_DIR, "rayleigh.ts")
    t = {}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[key] = (time.perf_counter() - t0) * 1e3
        return out

    clock("pt_write_ms", lambda: export_simclutter_pt(pt, ds))
    if clock("store_write_ms", lambda: save_store(store, ds)) != store:
        raise AssertionError("the store fell back to .npz")
    d = clock("pt_load_ms", lambda: torch.load(pt, map_location="cpu",
                                               weights_only=True))
    clock("pt_to_card_ms", lambda: {k: d[k].to(dev) for k in
                                    ("rayleigh_imgs", "rayleigh_labels")})
    views = clock("store_open_ms", lambda: load_store(store, copy=False,
                                                      device="cpu"))
    on_card = clock("store_to_card_ms", lambda: {k: v.to(dev) for k, v in
                                                 views.items()})
    direct = clock("store_load_to_card_ms", lambda: load_store(store))
    ok = (torch.equal(d["rayleigh_imgs"],
                      ds["imgs"].permute(0, 3, 1, 2).cpu())
          and torch.equal(d["rayleigh_labels"], ds["labels"].cpu())
          and d["psnr"] == ds["psnr"].tolist()
          and all(torch.equal(on_card[k], ds[k]) and
                  torch.equal(direct[k], ds[k]) for k in ds))
    nbytes = sum(v.numel() * v.element_size() for v in ds.values())
    log(f"[data] {len(ds['imgs'])} frames of {SIM_CROP}^2 ({nbytes} bytes): "
        f".pt {os.path.getsize(pt)} bytes, store {os.path.getsize(store)} "
        f"bytes, both read back bit-equal: {ok}; ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    if not ok:
        raise AssertionError("a data file did not read back bit-equal")
    del d, views, on_card, direct
    t0 = time.perf_counter()
    report = verify_dataset(pt)
    t["verify_ms"] = (time.perf_counter() - t0) * 1e3
    log(format_report(report))
    if not report["ok"] or report["eval"]["batch"] != [2, SIM_CROP,
                                                       SIM_CROP, 1] or \
            not np.isfinite(report["eval"]["loss"]):
        raise AssertionError(f"verify_dataset: {report}")
    res["data_ms"] = t
    res["data_bytes"] = nbytes
    res["verify_loss"] = report["eval"]["loss"]


def serving_surfaces(TC, dev, ckpt: str) -> dict:
    """Phase 9: the serving and data surfaces at full width (base 64, bf16,
    pair-packed, tile 512, halo 32, batch 8): tiled scenes through the
    daemon's ?scene=1 and infer_tiled, the single-file artifact, the
    bridge back to the reference on phase 6's checkpoint ``ckpt``, the .pt
    export, the tile store and the verifier. Its files go to PHASE9_DIR,
    removed at the end."""
    res = {}
    os.makedirs(PHASE9_DIR, exist_ok=True)
    try:
        tiled_scenes(TC, dev, res)
        artifact_serving(TC, dev, res)
        bridge_round_trip(dev, res, ckpt)
        data_files(dev, res)
    finally:
        shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 10: int8 serving and int8 training
# ---------------------------------------------------------------------------

PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core operations/s
Q_BATCHES = (8, 32)
Q_TRAIN_STEPS = 5
Q_TRAIN_RTOL = 0.08     # the JAX package's gate, tests/test_qtrain.py:82
Q_AGREE_MIN = 0.99      # models/quant.py's contract
Q_AGREE_GATE = 0.999    # the ROADMAP's gate, measured by runs/quant_validate.py
# phase 6's run is continued to this many epochs before it is quantized:
# int8/bf16 mask agreement on the held-out split rises with training,
# 0.988 at phase 6's 4 epochs, 0.990 at 10, 0.993 at 20, 0.995 at 40
# (onet_tpu_torch/runs/quant_validate.py --train-epochs 4,10,20,40); the
# JAX package's own int8 graph reads 0.989 on phase 6's model as well
# (runs/quant_witness.py)
Q_EPOCHS = 20
# int8 launches a served batch: one a site, inc.conv2 and up4.conv2 in
# bf16 with head_bf16
Q_LAUNCHES = {True: {"conv3x3_i8": 16, "convT2x2_i8": 4},
              False: {"conv3x3_i8": 18, "convT2x2_i8": 4}}
# int8 launches a train step: the 18 3x3 convs forward; with "fwd+dx" their
# input-gradient convs too, but for the first one, whose input (the frames
# and their complement) needs no gradient
Q_STEP_FWD, Q_STEP_DX = 18, 17
# the sites whose times stand in the kernels JSON line
Q_HEADLINE = {"conv3x3_i8": "up4.conv1", "convT2x2_i8": "up4.up"}
Q_REPLACES = {"conv3x3_i8": "onet_tpu/models/quant.py:257",
              "convT2x2_i8": "onet_tpu/models/quant.py:307"}
PHASE10_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runs", "chip_smoke_phase10")


def q_frames(dev, n: int, seed: int) -> torch.Tensor:
    """n Rayleigh-clutter frames at 512^2 with phase 6's targets, drawn on
    the card over its PSNR levels in turn: [n, H, W, 1] in [0, 1]."""
    from onet_tpu_torch.sim.rayleigh import rayleigh_frames

    g = torch.Generator(dev).manual_seed(seed)
    per = -(-n // len(SIM_LEVELS))
    xs = [rayleigh_frames(g, float(lvl), n_frames=per, frame_size=H,
                          crop=H, device=dev)[0] for lvl in SIM_LEVELS]
    return torch.stack(xs, dim=1).reshape(-1, H, W)[:n, ..., None]


def i8_counts(CI) -> dict:
    return {"conv3x3_i8": CI.conv3x3_i8.launches,
            "convT2x2_i8": CI.convT2x2_i8.launches}


def i8_reset(CI) -> None:
    CI.conv3x3_i8.launches = CI.convT2x2_i8.launches = 0


def i8_operands(CI, run) -> list:
    """Every int8 kernel launch of ``run()`` as the wrappers gave it to the
    kernel: (convt, x, w, scale, bias, s_next, mode, y), held (not copied)
    until the list goes."""
    ops, real = [], CI._launch

    def capture(x, w, scale, bias, s_next, mode, convt):
        y = real(x, w, scale, bias, s_next, mode, convt)
        ops.append((convt, x, w, scale, bias, s_next, mode, y))
        return y

    CI._launch = capture
    try:
        run()
    finally:
        CI._launch = real
    return ops


def i8_check(CI, op, tag: str) -> float:
    """One captured launch on a batch-1 slice of its operands: the kernel's
    int32 accumulator (run again in that mode, not counted) and the plain
    version's (float64 on the codes) bit-equal; the captured int8 codes
    bit-equal to the plain epilogue's; f32 outputs within one f32
    rounding (their largest |difference| is returned)."""
    convt, x, w, scale, bias, s_next, mode, y = op
    x1 = x[:1]
    acc = CI._launch(x1, w, None, None, None, CI.OUT_I32, convt)
    ref = CI.plain(x1, w, None, None, None, CI.OUT_I32, convt)
    if not torch.equal(acc, ref):
        bad = int((acc != ref).sum())
        raise AssertionError(f"{tag}: {bad} int32 sums differ from plain")
    want = CI.epilogue_plain(ref, scale, bias, s_next, mode)
    got = y[:1]
    if got.dtype != want.dtype:
        raise AssertionError(f"{tag}: {got.dtype} against {want.dtype}")
    if mode in (CI.OUT_U8, CI.OUT_S8):
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{tag}: {bad} int8 codes differ")
        return 0.0
    diff = (got - want).abs()
    if not bool((diff <= torch.finfo(torch.float32).eps
                 * want.abs()).all()):
        raise AssertionError(f"{tag}: f32 output off by {diff.max()}")
    return diff.max().item()


def i8_bound(op) -> tuple:
    """(ms, 'bytes' | 'operations') of one launch: 2 pixels x columns x K
    operations on the int8 tensor cores (K the real 9 ci or ci, no
    padding), x and w read once, y (and the [co] vectors) written once."""
    convt, x, w, scale, bias, s_next, _, y = op
    n, h, wd, ci = x.shape
    cols = w.shape[3] * (4 if convt else 1)
    ops = 2 * n * h * wd * cols * ci * (1 if convt else 9)
    nbytes = (x.numel() + w.numel() + y.numel() * y.element_size()
              + sum(4 * t.numel() for t in (scale, bias, s_next)
                    if t is not None))
    t_ops, t_bytes = ops / PEAK_INT8 * 1e3, nbytes / HBM * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def i8_time(CI, op) -> dict:
    """A captured launch at its full batch: the kernel alone on operands
    laid out beforehand (L2 flushed; profiler device time; warm), the
    wrapper (with its per-call weight layout and input padding), the
    library call it stands beside (cuDNN's bf16 conv at the same shape;
    for the transposed conv ``torch._int_mm`` on its GEMM, no scatter),
    and the plain version (float64 on the codes, warm)."""
    import torch.nn.functional as F

    convt, x, w, scale, bias, s_next, mode, _ = op
    xk, b, _, kpad, vec = CI.operands(x, w, convt)
    co = w.shape[3]

    def run():
        return CI.kernel(xk, b, vec, kpad, co, scale, bias, s_next, mode,
                         convt)

    t = {"ms": cold_ms(run), "device_ms": device_ms(run, kernels=1),
         "warm_ms": cuda_ms(run),
         "wrapper_ms": cold_ms(lambda: CI._launch(x, w, scale, bias, s_next,
                                                  mode, convt))}
    n, h, wd, ci = x.shape
    if convt:
        xm = x.reshape(-1, ci).contiguous()
        bm = w.flip(0, 1).permute(2, 0, 1, 3).reshape(ci, -1).contiguous()
        lib = (None if xm.shape[0] <= 16 or ci % 8 or bm.shape[1] % 8
               else (lambda: torch._int_mm(xm, bm)))
    else:
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
        lib = lambda: F.conv2d(xb, wb, padding=1)   # noqa: E731
    t["library_ms"] = None if lib is None else cold_ms(lib)
    t["library_device_ms"] = None if lib is None else device_ms(lib)
    # events behind a spin kernel, no profiler: a time where the
    # profiler drops the library call's records
    t["library_queued_ms"] = None if lib is None else queued_ms(lib)
    t["bound_ms"], t["bound_by"] = i8_bound(op)
    t["plain_ms"] = cuda_ms(lambda: CI.plain(x, w, scale, bias, s_next, mode,
                                             convt), reps=3, warmup=1)
    return t


def log_agreement(q, folded, x, tag: str) -> dict:
    """runs/quant_validate.py's mask agreements on ``x``, logged."""
    from onet_tpu_torch.runs.quant_validate import agreement, graph_masks

    out = agreement(graph_masks(q, folded, x))
    log(f"[int8] mask agreement with the bf16 folded graph, {tag} "
        f"{tuple(x.shape)}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in out.items()))
    return out


def q_serving(CI, dev, res, folded, calib, held) -> dict:
    """Phase 10, steps 2-3: calibration and quantization, then the int8
    graph at batch 8 and 32 with both head_bf16 values beside the bf16
    stacked and pair-packed steps; launches counted per batch; mask
    agreement with the bf16 folded graph on the held-out frames (gated)
    and on 512^2 frames; every int8 launch of one batch (each head form)
    against its plain version on the card; each site's kernel timed.
    Returns q."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import onet_infer
    from onet_tpu_torch.models.quant import (SITES, calibrate, onet_infer_q,
                                             quantize_folded)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        q = quantize_folded(folded, calibrate(folded, calib))
    torch.cuda.synchronize()
    res["quantize_s"] = time.perf_counter() - t0
    frames512 = q_frames(dev, max(Q_BATCHES), SEED + 200)
    with torch.inference_mode():
        for hb in (True, False):
            i8_reset(CI)
            s_q, _ = onet_infer_q(q, frames512[:8], head_bf16=hb)
            torch.cuda.synchronize()
            got = i8_counts(CI)
            if got != Q_LAUNCHES[hb]:
                raise AssertionError(f"int8 batch (head_bf16={hb}) launched "
                                     f"{got}, expected {Q_LAUNCHES[hb]}")
            if s_q.shape != (8, H, W, 2) or not bool(
                    torch.isfinite(s_q).all()):
                raise AssertionError(f"int8 S {tuple(s_q.shape)} or "
                                     "non-finite")
    res["launches"] = {str(hb): Q_LAUNCHES[hb] for hb in (True, False)}
    log(f"[int8] calibration on {len(calib)} frames of the train split and "
        f"quantization {res['quantize_s']:.2f} s; launches a batch "
        f"{res['launches']}")
    res["agreement"] = log_agreement(q, folded, held, "held-out test split")
    res["agreement_512"] = log_agreement(q, folded, frames512[:8],
                                       "512^2 Rayleigh frames")
    agree = [res["agreement"][f"int8_head_bf16={hb}"] for hb in (True,
                                                                 False)]
    log(f"[int8] held-out agreement {min(agree):.6f} against the contract "
        f"{Q_AGREE_MIN} (gated) and the ROADMAP's gate {Q_AGREE_GATE} "
        f"({'met' if min(agree) >= Q_AGREE_GATE else 'not met'})")
    if min(agree) < Q_AGREE_MIN:
        raise AssertionError(f"int8 mask agreement {res['agreement']} < "
                             f"{Q_AGREE_MIN}")
    # every launch of one batch, each head form, against its plain version
    err, sites = 0.0, {}
    for hb in (True, False):
        with torch.inference_mode():
            ops = i8_operands(CI, lambda: onet_infer_q(q, frames512[:8],
                                                       head_bf16=hb))
        names = [s for s in SITES if not (hb and s in ("inc.conv2",
                                                       "up4.conv2"))]
        if len(ops) != len(names) or any(
                op[0] != n.endswith(".up") for op, n in zip(ops, names)):
            raise AssertionError(f"int8 launches {len(ops)} out of order")
        for name, op in zip(names, ops):
            tag = f"int8 {name} (head_bf16={hb}) x {tuple(op[1].shape)}"
            with torch.inference_mode():
                err = max(err, i8_check(CI, op, tag))
        log(f"[int8] head_bf16={hb}: all {len(ops)} launches of a batch-8 "
            f"step held on their batch-1 slices: int32 sums and int8 codes "
            f"bit-equal, f32 outputs within {err:.3e}")
        if hb:
            bf16_head_names = names
        else:
            sites = dict(zip(names, ops))
        del ops
    res["max_abs_err"] = err

    # each site's kernel timed at batch 8, and its launches a served batch
    # (bf16 head, int8 head)
    res["sites"] = {}
    with torch.inference_mode():
        for name, op in sites.items():
            t = i8_time(CI, op)
            t["shape"] = [list(op[1].shape), list(op[2].shape)]
            t["launches"] = [int(name in bf16_head_names), 1]
            res["sites"][name] = t
            log(f"[int8] site {name} x {tuple(op[1].shape)} w "
                f"{tuple(op[2].shape)}: kernel {t['ms']:.4f} ms (device "
                f"{fmt_ms(t['device_ms'], 4)}, warm {t['warm_ms']:.4f}), "
                f"wrapper {t['wrapper_ms']:.4f}, bound {t['bound_ms']:.4f} "
                f"({t['bound_by']}), library "
                f"{fmt_ms(t['library_ms'], 4)} (device "
                f"{fmt_ms(t['library_device_ms'], 4)}, queued "
                f"{fmt_ms(t['library_queued_ms'], 4)}), plain "
                f"{t['plain_ms']:.3f}; launches a batch {t['launches']}")
    del sites
    torch.cuda.empty_cache()

    # the int8 steps beside the bf16 stacked and pair-packed steps
    with torch.inference_mode():
        for b in Q_BATCHES:
            xb = frames512[:b]
            for hb in (True, False):
                key = f"b{b}_int8{'_bf16head' if hb else ''}_step_ms"
                res[key] = cuda_ms(lambda: onet_infer_q(q, xb, head_bf16=hb),
                                   reps=5, warmup=2)
            for wp in (False, True):
                key = f"b{b}_bf16_{'wp' if wp else 'stacked'}_step_ms"
                res[key] = cuda_ms(lambda: onet_infer(
                    folded, xb, policy=BF16_COMPUTE, pair_pack=wp),
                    reps=5, warmup=2)
            torch.cuda.empty_cache()
        res["b8_int8_profile"] = breakdown(
            lambda: onet_infer_q(q, frames512[:8]), "int8 batch 8 step "
            "(bf16 head)", top=12)
    log(f"[int8] 512x512 steps (ms): " + ", ".join(
        f"{k[:-8]} {v:.3f}" for k, v in res.items() if k.endswith("_step_ms")))
    del frames512
    return q


def q_http(CI, dev, res, q) -> None:
    """Phase 10, step 4: the int8 step behind the daemon at batch 8."""
    from onet_tpu_torch.models.quant import onet_infer_q
    from onet_tpu_torch.serve.http import ServingSession

    sess = ServingSession(lambda q_, xb: onet_infer_q(q_, xb), q, batch=8,
                          in_channels=1, mode="int8+bf16head",
                          model_name="phase6-checkpoint", input_hw=(H, W))
    sess.warmup()
    reqs = [q_frames(dev, 8, SEED + 210 + i).cpu().numpy() for i in range(3)]
    httpd, th, url = serve_in_thread(sess)
    try:
        i8_reset(CI)
        masks = [post(url + "/segment", r) for r in reqs]
        launches = i8_counts(CI)
        stats = get_json(url + "/stats")
    finally:
        stop_server(httpd, th)
    want = {k: 3 * v for k, v in Q_LAUNCHES[True].items()}
    if launches != want:
        raise AssertionError(f"int8 HTTP launches {launches}, expected {want}")
    with torch.inference_mode():
        for r, m in zip(reqs, masks):
            _, lab = onet_infer_q(q, torch.from_numpy(r).to(dev))
            if not np.array_equal(m, lab.cpu().numpy().astype(np.uint8)):
                raise AssertionError("int8 HTTP masks differ from a direct "
                                     "call")
    res["http_request_ms_p50"] = stats["total_ms"]["p50"]
    log(f"[int8] HTTP: 3 requests of 8 frames, launches {launches}, masks "
        f"equal to direct calls; request p50 "
        f"{res['http_request_ms_p50']:.2f} ms; stats {stats}")


def q_artifact(CI, dev, res, params, state, q, calib) -> None:
    """Phase 10, step 5: the int8 artifact exported on the card with the
    calibration frames, loaded afresh, serving batch 8: its calls launch
    the int8 kernels, its S equals the live int8 step's."""
    from onet_tpu_torch.models.quant import onet_infer_q
    from onet_tpu_torch.serve.artifact import (export_serving_artifact,
                                               load_serving_artifact)

    path = os.path.join(PHASE10_DIR, "onet_int8_512.onetp")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = export_serving_artifact(params, state, path, input_hw=(H, W),
                                   int8_calib=calib)
    res["artifact_export_s"] = time.perf_counter() - t0
    res["artifact_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    call, meta_read = load_serving_artifact(path)
    res["artifact_load_s"] = time.perf_counter() - t0
    if meta_read != meta or meta["arithmetic"] != "int8+bf16head":
        raise AssertionError(f"int8 artifact header {meta_read}")
    x8 = q_frames(dev, 8, SEED + 220)
    i8_reset(CI)
    s_art, l_art = call(x8)
    torch.cuda.synchronize()
    launches = i8_counts(CI)
    with torch.inference_mode():
        s_live, l_live = onet_infer_q(q, x8)
    same = bool(torch.equal(s_art, s_live)) and bool(torch.equal(
        l_art, l_live.to(torch.int32)))
    res["artifact_launches"] = launches
    res["artifact_equals_live"] = same
    res["artifact_step_ms"] = cuda_ms(lambda: call(x8), reps=5, warmup=2)
    log(f"[int8] artifact: exported in {res['artifact_export_s']:.2f} s, "
        f"{res['artifact_bytes']} bytes, loaded in "
        f"{res['artifact_load_s']:.2f} s; a batch of 8 launched {launches}; "
        f"S and masks equal to the live int8 step: {same}; step "
        f"{res['artifact_step_ms']:.3f} ms")
    if launches != Q_LAUNCHES[True]:
        raise AssertionError(f"the int8 artifact launched {launches}")
    if not same:
        raise AssertionError("the int8 artifact's S differs from the live "
                             "int8 step's")
    del call


def q_train(CI, dev, res) -> None:
    """Phase 10, step 6: make_train_step(quantized="fwd" and "fwd+dx") for
    Q_TRAIN_STEPS steps at 512^2, batch 8, bf16, Adam at lr 1e-5, from
    phase 4's init and frames, beside the exact stacked step; launches per
    step asserted; step times."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    gen = torch.Generator().manual_seed(SEED + 20)
    params0, state0 = O.onet_init(gen, 1, base=64)
    xs = [torch.from_numpy(frames(8, SEED + 30 + i)).to(dev)
          for i in range(Q_TRAIN_STEPS)]
    losses, steps = {}, {}
    for level in (None, "fwd", "fwd+dx"):
        key = level or "exact"
        p, st, o = _clone(params0), _clone(state0), adam_init(params0)
        with pair_pack(O, False):
            step = make_train_step(policy=BF16_COMPUTE, quantized=level)
            i8_reset(CI)
            out = []
            for x in xs:
                p, st, o, loss = step(p, st, o, x, LR)
                out.append(loss.item())
            launches = i8_counts(CI)
            per = (0 if level is None else Q_STEP_FWD
                   + (Q_STEP_DX if level == "fwd+dx" else 0))
            want = {"conv3x3_i8": per * Q_TRAIN_STEPS, "convT2x2_i8": 0}
            if launches != want:
                raise AssertionError(f"train {key}: launches {launches}, "
                                     f"expected {want}")
            steps[key] = cuda_ms(lambda: step(p, st, o, xs[0], LR), reps=5,
                                 warmup=1)
        losses[key] = out
        log(f"[int8] train {key}: losses {out}; int8 launches in "
            f"{Q_TRAIN_STEPS} steps {launches}; step {steps[key]:.2f} ms")
        del p, st, o
        torch.cuda.empty_cache()
    res["train_losses"] = losses
    res["train_step_ms"] = steps
    res["train_launches_per_step"] = {"fwd": Q_STEP_FWD,
                                      "fwd+dx": Q_STEP_FWD + Q_STEP_DX}
    last = losses["exact"][-1]
    for level in ("fwd", "fwd+dx"):
        if not all(np.isfinite(losses[level])):
            raise AssertionError(f"train {level}: non-finite loss")
        rel = abs(losses[level][-1] - last) / abs(last)
        res[f"train_{level}_loss_rel"] = rel
        if rel > Q_TRAIN_RTOL:
            raise AssertionError(f"train {level}: step-{Q_TRAIN_STEPS} loss "
                                 f"{losses[level][-1]} vs exact {last}")


def q_simclutter(CI, res) -> None:
    """Phase 10, step 7: one epoch of the simclutter driver at its defaults
    (224^2, batch 10, base 64), bf16, quantized="fwd+dx"."""
    import tempfile

    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.data.arrays import num_batches
    from onet_tpu_torch.train import simclutter as SC

    out_root = tempfile.mkdtemp(prefix="onet_simclutter_q_")
    try:
        i8_reset(CI)
        t0 = time.perf_counter()
        _, _, hist = SC.train(SC.SimclutterConfig(
            quantized="fwd+dx", epoch_nums=1, save_epochs=(),
            out_root=out_root, input_sz=SIM_CROP,
            frames_per_level=SIM_FRAMES, base_channels=SIM_BASE),
            policy=BF16_COMPUTE, log=False)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    launches = i8_counts(CI)
    n_train = int(len(SIM_LEVELS) * SIM_FRAMES * 0.9)
    steps = num_batches(n_train, SIM_BATCH)
    want = {"conv3x3_i8": steps * (Q_STEP_FWD + Q_STEP_DX), "convT2x2_i8": 0}
    res["sim_epoch_s"] = wall
    res["sim_loss"] = hist["loss"][0]
    res["sim_eval"] = hist["eval"]
    log(f"[int8] simclutter driver, quantized=fwd+dx, 1 epoch at "
        f"{SIM_CROP}^2 batch {SIM_BATCH}: {steps} steps, {wall:.2f} s with "
        f"data generation, loss {hist['loss'][0]:.6f}, eval {hist['eval']}; "
        f"int8 launches {launches}")
    if launches != want:
        raise AssertionError(f"simclutter int8 launches {launches}, "
                             f"expected {want}")
    if not np.isfinite(hist["loss"][0]):
        raise AssertionError("simclutter int8 loss is not finite")


def q_continue(ckpt: str) -> str:
    """Phase 10, step 1: phase 6's run continued from its last checkpoint
    ``ckpt`` to Q_EPOCHS epochs (the driver's resume, phase 6's config:
    the same data, schedule and Adam state; bf16, pair-packed). Returns
    the last checkpoint, in PHASE10_DIR."""
    import tempfile

    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train import simclutter as SC

    out_root = tempfile.mkdtemp(prefix="onet_simclutter_resume_")
    try:
        shutil.copy(ckpt, out_root)
        t0 = time.perf_counter()
        with pair_pack(O, True):
            _, _, hist = SC.train(SC.SimclutterConfig(
                epoch_nums=Q_EPOCHS, resume=True, save_epochs=(),
                eval_every=10 ** 6, out_root=out_root, input_sz=SIM_CROP,
                frames_per_level=SIM_FRAMES, base_channels=SIM_BASE),
                policy=BF16_COMPUTE, log=False)
        log(f"[int8] phase 6's run resumed to {Q_EPOCHS} epochs in "
            f"{time.perf_counter() - t0:.1f} s: losses {hist['loss']}, "
            f"eval {hist['eval']}")
        return shutil.copy(newest_checkpoint(out_root), PHASE10_DIR)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)


def int8_workload(dev, ckpt: str) -> dict:
    """Phase 10: int8 serving and training at full width (base 64): phase
    6's run continued to Q_EPOCHS epochs (phase 6's own checkpoint sits
    too close to the softmax's edge for the 0.99 contract, and its
    agreement is reported beside), calibration and quantization, the int8
    graph against its plain versions and the bf16 graph, HTTP, the int8
    artifact, int8 training and the simclutter driver with int8
    training."""
    from onet_tpu_torch.core.bridge import load_onet_npz
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.models.unet import param_count
    from onet_tpu_torch.ops import conv_i8 as CI
    from onet_tpu_torch.runs.quant_validate import held_out, quantized

    res = {}
    calib, held = held_out(dev)
    params, state, epoch = load_onet_npz(ckpt)
    folded, _, q = quantized(params, state, calib)
    res["agreement_phase6"] = log_agreement(
        q, folded, held, f"phase 6's checkpoint (epoch index {epoch}), "
        "held-out test split, not gated")
    del params, state, folded, q
    path = q_continue(ckpt)
    params, state, epoch = load_onet_npz(path)
    res["checkpoint"] = f"{os.path.basename(path)} (epoch index {epoch})"
    res["params"] = param_count(params)
    log(f"[int8] model {res['checkpoint']}, {res['params']} params")
    with torch.inference_mode():
        folded = fold_onet(params, state)
    q = q_serving(CI, dev, res, folded, calib, held)
    q_http(CI, dev, res, q)
    q_artifact(CI, dev, res, params, state, q, calib)
    del q, folded, params, state, calib, held
    torch.cuda.empty_cache()
    q_train(CI, dev, res)
    q_simclutter(CI, res)
    return res


# ---------------------------------------------------------------------------
# phase 11: the other model families and the baselines
# ---------------------------------------------------------------------------

FAMILIES = ("swin", "convnext", "transunet")   # at the registry's defaults:
# Swin-T (embed 96, depths 2-2-2-2, heads 3-6-12-24, window 7), ConvNeXt-T
# (embed 96, depths 3-3-9-3), TransUNet ViT-B (embed 768, depth 12,
# img_size 224)
FAM_EPOCHS = 1                  # of Zy3Config's 11 / SimclutterConfig's 301
FAM_SERVE_HW, FAM_SERVE_BATCH = 512, 8   # the serving shape of phase 3
FAM_VERIFY_LEVELS = (0, 5, 10)  # per_snr_datasets' levels for the mixed dir
FAM_CHECK_FRAMES = 2            # card float32 against CPU float32
PHASE11_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runs", "chip_smoke_phase11")


def all_launches() -> dict:
    """Every hand-written kernel wrapper's launch counter."""
    from onet_tpu_torch.ops import conv_bd as BD
    from onet_tpu_torch.ops import conv_i8 as CI
    from onet_tpu_torch.ops import conv_wp as TC
    from onet_tpu_torch.ops import head as HD

    fns = {"conv3x3_wp": TC.conv3x3_wp_raw, "conv3x3_wp2": TC.conv3x3_wp2_raw,
           "conv3x3_wp_dw": TC.conv3x3_wp_dw, "jsd_loss_fwd": HD.jsd_loss_fwd,
           "jsd_loss_bwd": HD.jsd_loss_bwd,
           "minmax_complement": HD.minmax_complement,
           "conv3x3_bd": BD.conv3x3_bd_raw,
           "conv3x3_bd2in": BD.conv3x3_bd2in_raw,
           "conv3x3_i8": CI.conv3x3_i8, "convT2x2_i8": CI.convT2x2_i8}
    return {k: f.launches for k, f in fns.items()}


def fam_step_times(tag, step, frames: int) -> dict:
    """A train step's ms (CUDA events, median of 5 after 2 warm-ups),
    frames/s, and the profiler's idle share of one step."""
    ms = cuda_ms(step)
    prof = breakdown(step, f"{tag} train step", top=5)
    return {"step_ms": ms, "frames_per_s": frames / ms * 1e3,
            "idle_share": prof["idle_share"], "kernels": prof["kernels"]}


def fam_zy3(dev, res, train_ds, test_ds) -> None:
    """Phase 11, step 1: each backbone through train/zy3.py's train() with
    arch= (Zy3Config's defaults, FAM_EPOCHS epoch), its epoch's train and
    eval times read around the driver's own calls, peak memory, parameter
    count, the milestone reloaded through load_arch_auto (bit-equal to the
    returned state); then its train step alone at phase 8's shape."""
    import glob
    import tempfile

    from onet_tpu_torch.core.checkpoint import load_arch_auto
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.data.augment import augment_batch
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.models.unet import param_count, tree_leaves, tree_map
    from onet_tpu_torch.train import zy3 as Z
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    for name in FAMILIES:
        marks = {"train": [], "eval": [], "eval_end": []}
        real_eval, real_iter = Z.evaluate_zy3, Z.batch_iterator

        def timed_eval(*a, **kw):
            torch.cuda.synchronize()
            marks["eval"].append(time.perf_counter())
            out = real_eval(*a, **kw)
            torch.cuda.synchronize()
            marks["eval_end"].append(time.perf_counter())
            return out

        def marked_iter(ds, batch_size, *, gen=None, **kw):
            if gen is not None:
                torch.cuda.synchronize()
                marks["train"].append(time.perf_counter())
            return real_iter(ds, batch_size, gen=gen, **kw)

        out_root = tempfile.mkdtemp(prefix=f"onet_{name}_zy3_")
        cfg = Z.Zy3Config(epoch_nums=FAM_EPOCHS, arch=name, save_epochs=(),
                          model_name=f"onet_{name}_zy3", out_root=out_root)
        Z.evaluate_zy3, Z.batch_iterator = timed_eval, marked_iter
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, hist = Z.train(cfg, train_ds, test_ds,
                                          policy=BF16_COMPUTE, log=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            Z.evaluate_zy3, Z.batch_iterator = real_eval, real_iter
        train_s = marks["eval"][0] - marks["train"][0]
        eval_s = marks["eval_end"][0] - marks["eval"][0]
        m = hist["eval"][FAM_EPOCHS - 1]
        if not all(np.isfinite(hist["loss"])) or not all(
                0.0 <= m[k] <= 1.0 for k in ("acc", "miou", "dr", "far",
                                              "tiou")):
            raise AssertionError(f"{name}: zy3 history off: {hist}")
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
            raise AssertionError(f"{name}: non-finite parameter")
        saved = glob.glob(os.path.join(out_root, f"{cfg.model_name}_epoch"
                                       f"{FAM_EPOCHS - 1}_*.npz"))
        if len(saved) != 1:
            raise AssertionError(f"{name}: milestones {os.listdir(out_root)}")
        t0 = time.perf_counter()
        arch, p2, s2, e2 = load_arch_auto(saved[0])
        reload_s = time.perf_counter() - t0
        if arch.name != name or e2 != FAM_EPOCHS - 1 or s2 != {"top": {}} \
                or not all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(p2), tree_leaves(params))):
            raise AssertionError(f"{name}: load_arch_auto gave another model")
        shutil.rmtree(out_root)
        del p2
        rec = {"params": param_count(params), "loss": hist["loss"],
               "eval": m, "train_s": train_s, "eval_s": eval_s,
               "driver_frames_per_s": len(train_ds) * FAM_EPOCHS / train_s,
               "train_wall_s": wall, "peak_gib": peak,
               "reload_s": reload_s}
        # the step alone at phase 8's shape: batch 5, augmented, 224^2 RGB
        arch = get_arch(name)
        p = tree_map(torch.clone, params)
        opt = adam_init(p)
        step = make_train_step(policy=BF16_COMPUTE, forward=arch.forward)
        x = augment_batch(make_generator(SEED + 110, dev),
                          train_ds["imgs"][:cfg.batch_sz])
        torch.cuda.reset_peak_memory_stats()
        rec["zy3_step"] = fam_step_times(
            f"[families] {name} zy3", lambda: step(p, state, opt, x, 1e-4),
            cfg.batch_sz)
        rec["zy3_step"]["peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
        del p, opt, params
        res[name] = rec
        log(f"[families] {name} zy3 train(): {rec['params']} params, epoch "
            f"train {train_s:.3f} s ({rec['driver_frames_per_s']:.1f} "
            f"frames/s), eval {eval_s:.3f} s, peak {peak:.2f} GiB, loss "
            f"{hist['loss']}, eval {m}; load_arch_auto {reload_s:.2f} s; "
            f"step alone (batch 5) {rec['zy3_step']['step_ms']:.3f} ms "
            f"({rec['zy3_step']['frames_per_s']:.1f} frames/s, idle share "
            f"{rec['zy3_step']['idle_share']:.3f}, "
            f"{rec['zy3_step']['kernels']} kernels)")


def fam_phase6_steps(dev, res) -> None:
    """Phase 11, step 2: each backbone's train step at phase 6's shape
    (batch 10, 224^2, one channel), from a seeded init."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    x = torch.rand((SIM_BATCH, SIM_CROP, SIM_CROP, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    for name in FAMILIES:
        arch = get_arch(name)
        p, s = arch.init(torch.Generator().manual_seed(SEED), 1)
        opt = adam_init(p)
        step = make_train_step(policy=BF16_COMPUTE, forward=arch.forward)
        torch.cuda.reset_peak_memory_stats()
        rec = fam_step_times(f"[families] {name} simclutter",
                             lambda: step(p, s, opt, x, 1e-5), SIM_BATCH)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res[name]["sim_step"] = rec
        log(f"[families] {name} step at phase 6's shape (batch "
            f"{SIM_BATCH}, {SIM_CROP}^2, 1 channel): {rec['step_ms']:.3f} "
            f"ms, {rec['frames_per_s']:.1f} frames/s, idle share "
            f"{rec['idle_share']:.3f}, peak {rec['peak_gib']:.2f} GiB")
        del p, s, opt
        torch.cuda.empty_cache()


def fam_simclutter(dev, res, vanilla_ckpt: str) -> None:
    """Phase 11, step 3: train/simclutter.py's train(arch="swin") for
    FAM_EPOCHS epoch at SimclutterConfig's defaults (data generated by the
    driver on the card), then verify_checkpoint_dir over its milestone and
    phase 6's vanilla checkpoint in one directory."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.train import simclutter as SC
    from onet_tpu_torch.train.sweeps import per_snr_datasets, verify_checkpoint_dir

    out_root = os.path.join(PHASE11_DIR, "mixed")
    os.makedirs(out_root, exist_ok=True)
    cfg = SC.SimclutterConfig(epoch_nums=FAM_EPOCHS, arch="swin",
                              model_name="onet_swin_rayleigh",
                              save_epochs=(), out_root=out_root)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, hist = SC.train(cfg, policy=BF16_COMPUTE, log=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = hist["eval"][FAM_EPOCHS - 1]
    if not all(np.isfinite(hist["loss"])) or not all(
            0.0 <= v <= 1.0 for v in m.values()):
        raise AssertionError(f"swin simclutter history off: {hist}")
    shutil.copy(vanilla_ckpt, out_root)
    ds = per_snr_datasets(7, levels=FAM_VERIFY_LEVELS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    report = verify_checkpoint_dir(out_root, datasets_by_psnr=ds,
                                   policy=BF16_COMPUTE)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t1
    archs = sorted(r["arch"] for r in report.values())
    if archs != ["swin", "vanilla"] or not all(
            0.0 <= r["per_snr"]["ave"][k] <= 1.0 for r in report.values()
            for k in ("acc", "miou")):
        raise AssertionError(f"mixed-family verify_checkpoint_dir: {report}")
    res["simclutter_swin"] = {
        "train_wall_s": wall, "loss": hist["loss"], "eval": m,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "verify_s": verify_s,
        "verify": {f: {"arch": r["arch"], "epoch": r["epoch"],
                       "ave": r["per_snr"]["ave"]}
                   for f, r in report.items()}}
    shutil.rmtree(out_root)
    log(f"[families] simclutter train(arch='swin'), {FAM_EPOCHS} epoch: "
        f"{wall:.2f} s with generation, loss {hist['loss']}, eval {m}; "
        f"verify_checkpoint_dir (swin + phase 6's vanilla, levels "
        f"{FAM_VERIFY_LEVELS} x 150 frames) {verify_s:.2f} s: " + "; ".join(
            f"{r['arch']} acc {r['per_snr']['ave']['acc']:.4f} miou "
            f"{r['per_snr']['ave']['miou']:.4f}" for r in report.values()))


def fam_serving(dev, res) -> None:
    """Phase 11, step 4: a serving-size forward per backbone, bf16,
    512^2, batch 8 (16 frames through the weight-shared [2B] pass): Swin a
    window-8 init (its stages 128/64/32/16 are multiples of 8), TransUNet's
    14x14 position table resized to 32x32."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.arch import get_arch

    x = torch.rand((FAM_SERVE_BATCH, FAM_SERVE_HW, FAM_SERVE_HW, 1),
                   device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    for name in FAMILIES:
        arch = get_arch(name, swin_window=8)
        p, s = arch.init(torch.Generator().manual_seed(SEED), 1)
        if name == "transunet":
            assert tuple(p["top"]["pos"].shape[:2]) == (14, 14)

        def fwd():
            with torch.no_grad(), BF16_COMPUTE.precision():
                return arch.forward(p, s, x, policy=BF16_COMPUTE)[0].S

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fwd()
        if out.shape != (FAM_SERVE_BATCH, FAM_SERVE_HW, FAM_SERVE_HW, 2) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} 512^2 forward {tuple(out.shape)}")
        ms = cuda_ms(fwd)
        prof = breakdown(fwd, f"[families] {name} 512^2 forward", top=5)
        rec = {"ms": ms, "frames_per_s": FAM_SERVE_BATCH / ms * 1e3,
               "idle_share": prof["idle_share"], "kernels": prof["kernels"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        res[name]["serve_512"] = rec
        log(f"[families] {name} forward, bf16, {FAM_SERVE_HW}^2 batch "
            f"{FAM_SERVE_BATCH}: {ms:.3f} ms ({rec['frames_per_s']:.1f} "
            f"frames/s), idle share {rec['idle_share']:.3f}, peak "
            f"{rec['peak_gib']:.2f} GiB")
        del p, s, out


def fam_baselines(dev, res) -> None:
    """Phase 11, step 5: IIC and InfoSeg, FAM_EPOCHS epoch each of their
    train() at their defaults (levels 0-2 x 150 frames generated on the
    card, 224^2, batch 10, float32), each epoch's time and the final
    checkpoint."""
    import glob

    from onet_tpu_torch.train import iic as TI
    from onet_tpu_torch.train import infoseg as TF

    for name, mod, cfg in (
            ("iic", TI, TI.IICConfig(epoch_nums=FAM_EPOCHS,
                                     out_root=os.path.join(PHASE11_DIR,
                                                           "iic"))),
            ("infoseg", TF, TF.InfoSegConfig(
                epoch_nums=FAM_EPOCHS,
                out_root=os.path.join(PHASE11_DIR, "infoseg")))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, hist = mod.train(cfg, log=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = hist["eval"][FAM_EPOCHS - 1]
        saved = glob.glob(os.path.join(cfg.out_root, f"{cfg.model_name}_*_"
                                       f"epoch_{FAM_EPOCHS - 1}.npz"))
        if len(saved) != 1 or not all(np.isfinite(hist["loss"])) or not all(
                0.0 <= v <= 1.0 for v in m.values()):
            raise AssertionError(f"{name}: {hist}, saved {saved}")
        res[name] = {"train_wall_s": wall, "loss": hist["loss"], "eval": m,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        shutil.rmtree(cfg.out_root)
        log(f"[families] {name} train(), {FAM_EPOCHS} epoch with generation: "
            f"{wall:.2f} s, peak {res[name]['peak_gib']:.2f} GiB, loss "
            f"{hist['loss']}, eval {m}")


def fam_card_vs_cpu(dev, res) -> None:
    """Phase 11, step 6: per family, the card's float32 forward on
    FAM_CHECK_FRAMES frames against the port's CPU float32 forward of the
    same weights (atol 2e-5, rtol 1e-4 on S, or the baselines' probs)."""
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.models.iic import iic_forward, iic_init
    from onet_tpu_torch.models.infoseg import infoseg_forward, infoseg_init
    from onet_tpu_torch.models.unet import tree_map

    g = np.random.default_rng(SEED + 111)
    res["card_vs_cpu"] = {}
    for name in FAMILIES + ("iic", "infoseg"):
        cin = 1 if name in ("iic", "infoseg") else 3
        x = torch.tensor(g.uniform(0, 1, (FAM_CHECK_FRAMES, ZY3_SIZE,
                                          ZY3_SIZE, cin)), dtype=torch.float32)
        gen = torch.Generator().manual_seed(SEED)
        if name == "iic":
            p, s = iic_init(gen, 1, device="cpu")
            run = lambda p, s, x: iic_forward(p, s, x)[0].probs   # noqa: E731
        elif name == "infoseg":
            p, s = infoseg_init(gen, 1, device="cpu")
            run = lambda p, s, x: infoseg_forward(p, s, x)[0].probs  # noqa: E731
        else:
            arch = get_arch(name)
            p, s = arch.init(gen, cin, device="cpu")
            run = lambda p, s, x, f=arch.forward: f(p, s, x)[0].S  # noqa: E731
        with torch.no_grad(), DEFAULT.precision():
            want = run(p, s, x)
            got = run(tree_map(lambda t: t.to(dev), p),
                      tree_map(lambda t: t.to(dev), s), x.to(dev)).cpu()
        err = float((got - want).abs().max())
        res["card_vs_cpu"][name] = err
        log(f"[families] {name}: card float32 forward on {FAM_CHECK_FRAMES} "
            f"{ZY3_SIZE}^2 frames against the CPU's: max abs err {err:.3e}")
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def families_workload(dev, vanilla_ckpt: str) -> dict:
    """Phase 11: the other model families and the baselines at full width
    on the card (Swin-T, ConvNeXt-T and ViT-B TransUNet twins on the
    stateless Onet container; IIC and InfoSeg at base 64), with none of
    the hand-written kernels launched:

    1. each backbone through the ZY-3 driver with arch= (phase 8's data
       and defaults: 250 + 50 synthetic RGB 224^2 scenes, batch 5,
       augmented, bf16, one epoch), its reload through load_arch_auto,
       its step alone;
    2. each backbone's step at phase 6's shape (batch 10, 224^2);
    3. Swin through the simclutter driver (one epoch at its defaults), and
       verify_checkpoint_dir over it and phase 6's vanilla checkpoint;
    4. a 512^2 batch-8 bf16 forward per backbone (Swin window 8,
       TransUNet's position table resized to 32x32);
    5. IIC and InfoSeg, one epoch each of their train();
    6. every family's card float32 forward against its CPU one."""
    res = {}
    before = all_launches()
    os.makedirs(PHASE11_DIR, exist_ok=True)
    train_ds, test_ds, _, gen_s = zy3_data(dev)
    res["generate_s"] = gen_s
    fam_zy3(dev, res, train_ds, test_ds)
    del train_ds, test_ds
    fam_phase6_steps(dev, res)
    fam_simclutter(dev, res, vanilla_ckpt)
    fam_serving(dev, res)
    fam_baselines(dev, res)
    fam_card_vs_cpu(dev, res)
    after = all_launches()
    res["launches"] = {k: after[k] - before[k] for k in after}
    log(f"[families] hand-written kernel launches in phase 11: "
        f"{res['launches']}")
    if any(res["launches"].values()):
        raise AssertionError(f"phase 11 launched hand-written kernels: "
                             f"{res['launches']}")
    return res


# ---------------------------------------------------------------------------
# phase 12: the parallel training paths over torch.distributed
# ---------------------------------------------------------------------------

PHASE12_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runs", "chip_smoke_phase12")
# (mode, mesh shape, axis names, microbatches) of the many-rank worlds:
# float32 at 512^2, base 64, 2 frames a data shard. "dp_wp" is the
# data-parallel step on the pair-packed kernels (their BatchNorm sums
# all-reduced over "data"), held to the plain pair-packed step, with
# STEP_LAUNCHES asserted on every rank and step
PAR_CASES = (("dp", (2, 1), ("data", "space"), 1),
             ("dp_wp", (2, 1), ("data", "space"), 1),
             ("spatial", (1, 2), ("data", "space"), 1),
             ("spatial", (1, 2, 2), ("data", "space", "spacew"), 1),
             ("tp", (1, 2), ("data", "model"), 1),
             ("pp", (1, 2), ("data", "stage"), 2))
PAR_STEPS = 3


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _digest(*trees) -> str:
    import hashlib
    from onet_tpu_torch.models.unet import tree_leaves
    h = hashlib.sha256()
    for tree in trees:
        for t in tree_leaves(tree):
            h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _flat(tree) -> torch.Tensor:
    from onet_tpu_torch.models.unet import tree_leaves
    return torch.cat([t.detach().reshape(-1).double()
                      for t in tree_leaves(tree)])


def one_rank_world(TC, dev, trained) -> dict:
    """Phase 12 (a): an NCCL world of one rank in this process. The data-
    parallel train and eval steps on mesh (1, 1), bf16 batch 8 at 512^2,
    pair-packed and stacked, from phase 4's start: loss and parameters
    bit-equal to the plain step's, the pair-packed step's launches equal
    STEP_LAUNCHES each step and the eval's EVAL_LAUNCHES."""
    import torch.distributed as dist
    from onet_tpu_torch.core.mesh import make_mesh
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.models.unet import tree_leaves
    from onet_tpu_torch.parallel import multihost
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_eval_step, make_train_step

    rank_dev = multihost.initialize(f"localhost:{_free_port()}", 1, 0,
                                    device=dev)
    res = {"world": 1, "backend": dist.get_backend(),
           "cards": torch.cuda.device_count()}
    log(f"[par] (a) world size 1, backend {res['backend']}, "
        f"{res['cards']} card(s), device {rank_dev}")
    try:
        mesh = make_mesh((1, 1), ("data", "space"))
        gen = torch.Generator().manual_seed(SEED + 20)
        params0, state0 = O.onet_init(gen, 1, base=64, device=dev)
        batch = 8
        xs = [torch.from_numpy(frames(batch, SEED + 30 + i)).to(dev)
              for i in range(TRAIN_STEPS)]
        for wp in (True, False):
            key = "wp" if wp else "stacked"
            with pair_pack(O, wp):
                runs = {}
                for tag, kw in (("plain", {}), ("mesh", dict(mesh=mesh))):
                    step = make_train_step(policy=BF16_COMPUTE, **kw)
                    p, st, o = (_clone(params0), _clone(state0),
                                adam_init(params0))
                    losses, per_step = [], []
                    for x in xs:
                        reset_counts(TC)
                        p, st, o, loss = step(p, st, o, x, LR)
                        losses.append(loss.item())
                        c = launch_counts(TC)
                        per_step.append(
                            {"conv3x3_wp+stats": c["conv3x3_wp+stats"],
                             "conv3x3_wp+dx": c["conv3x3_wp"]
                             - c["conv3x3_wp+stats"],
                             "conv3x3_wp2+stats": c["conv3x3_wp2+stats"],
                             "conv3x3_wp_dw": c["conv3x3_wp_dw"]})
                    runs[tag] = (step, p, st, o, losses, per_step)
                _, p1, s1, o1, l1, _ = runs["plain"]
                step, p2, s2, o2, l2, launches = runs["mesh"]
                want = (STEP_LAUNCHES if wp else
                        {k: 0 for k in STEP_LAUNCHES})
                if any(c != want for c in launches):
                    raise AssertionError(
                        f"(a) {key}: launches a step {launches}, expected "
                        f"{want}")
                same = (l1 == l2 and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves([p1, s1, o1]), tree_leaves([p2, s2, o2]))))
                log(f"[par] (a) {key} bf16 batch {batch}: losses mesh {l2} "
                    f"plain {l1}; launches a step {launches[0]}; "
                    f"bit-equal {same}")
                if not same:
                    raise AssertionError(f"(a) {key}: the mesh (1, 1) step "
                                         "differs from the plain step")
                ms = cuda_ms(lambda: step(p2, s2, o2, xs[0], LR))
                res[f"{key}_step_ms"] = ms
                res[f"{key}_launches"] = launches[0]
                labels = (xs[0][..., 0] > 0.6).to(torch.int32)
                reset_counts(TC)
                m2, v2, pr2 = make_eval_step(policy=BF16_COMPUTE, mesh=mesh)(
                    p2, s2, xs[0], labels)
                c = launch_counts(TC)
                ev = {"conv3x3_wp+stats": c["conv3x3_wp+stats"],
                      "conv3x3_wp2+stats": c["conv3x3_wp2+stats"]}
                m1, v1, pr1 = make_eval_step(policy=BF16_COMPUTE)(
                    p2, s2, xs[0], labels)
                want_ev = (EVAL_LAUNCHES if wp else
                           {k: 0 for k in EVAL_LAUNCHES})
                if ev != want_ev or not torch.equal(pr1, pr2) or \
                        not torch.equal(v1, v2):
                    raise AssertionError(f"(a) {key} eval: launches {ev} "
                                         f"(expected {want_ev}) or output "
                                         "differs from the plain eval")
                res[f"{key}_eval_launches"] = ev
                phase4 = trained[f"train_b{batch}_{key}_step_ms"]
                log(f"[par] (a) {key}: mesh (1, 1) step {ms:.2f} ms, phase "
                    f"4's plain step {phase4:.2f} ms; eval launches {ev}")
                del runs, p1, s1, o1, p2, s2, o2
                torch.cuda.empty_cache()
        res["preempt_agreed"] = _preempt_over_nccl(mesh, dev)
    finally:
        dist.destroy_process_group()
    return res


def _preempt_over_nccl(mesh, dev) -> list:
    """The drivers' SIGTERM agreement over NCCL: a SIGTERM to this process
    is read one poll late (the MAX all-reduce runs without the host
    waiting) and then held."""
    import signal
    from onet_tpu_torch.train.preempt import PreemptGuard

    guard = PreemptGuard().install()
    try:
        seen = [guard.triggered_on_any(mesh.world, dev)]
        os.kill(os.getpid(), signal.SIGTERM)
        seen += [guard.triggered_on_any(mesh.world, dev),
                 guard.triggered_on_any(mesh.world, dev),
                 guard.settled_on_any(mesh.world)]
    finally:
        guard.restore()
    log(f"[par] (a) SIGTERM agreement over NCCL, polls then settled: {seen}")
    if seen != [False, False, True, True]:
        raise AssertionError(f"(a) SIGTERM agreement {seen}, expected "
                             "[False, False, True, True]")
    return seen


def _par_step(mode, mesh, microbatches):
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.train.steps import make_train_step
    if mode in ("dp", "dp_wp"):
        return make_train_step(mesh=mesh, policy=DEFAULT)
    if mode == "spatial":
        return make_train_step(mesh=mesh, spatial=True, policy=DEFAULT)
    if mode == "tp":
        from onet_tpu_torch.parallel.tensor import make_tp_train_step
        return make_tp_train_step(mesh, policy=DEFAULT)
    from onet_tpu_torch.parallel.pipeline import make_pp_train_step
    return make_pp_train_step(mesh, microbatches=microbatches,
                              policy=DEFAULT)


def _par_case(case, dev, hw: int = H) -> dict:
    """One case on this rank; rank 0 also runs the plain step on the
    global batch and compares. The pair-packed case runs both steps on
    the pair-packed path."""
    from onet_tpu_torch.core.mesh import make_mesh
    from onet_tpu_torch.models import onet as O

    mode, shape, names, mb = case
    n = int(np.prod(shape))
    mesh = make_mesh(shape, names, ranks=list(range(n)))
    if mesh is None:
        return None
    with pair_pack(O, mode == "dp_wp"):
        return _par_run(case, mesh, dev, hw)


def _par_run(case, mesh, dev, hw: int) -> dict:
    import torch.distributed as dist
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.ops import conv_wp as TC
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    mode, shape, names, mb = case
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(SEED + 20)
    params0, state0 = O.onet_init(gen, 1, base=64, device=dev)
    batch = 2 * mesh.shape.get("data", 1)
    x = torch.from_numpy(frames(batch, SEED + 40)[:, :hw, :hw]).to(dev)
    step = _par_step(mode, mesh, mb)
    v, bn, g = step.loss_and_grads(_clone(params0), _clone(state0), x)
    p, s, o = _clone(params0), _clone(state0), adam_init(params0)
    times, launches = [], []
    for i in range(PAR_STEPS):
        torch.cuda.synchronize()
        reset_counts(TC)
        t0 = time.perf_counter()
        p, s, o, loss = step(p, s, o, x, LR)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        c = launch_counts(TC)
        launches.append({"conv3x3_wp+stats": c["conv3x3_wp+stats"],
                         "conv3x3_wp+dx": c["conv3x3_wp"]
                         - c["conv3x3_wp+stats"],
                         "conv3x3_wp2+stats": c["conv3x3_wp2+stats"],
                         "conv3x3_wp_dw": c["conv3x3_wp_dw"]})
        if i == 0:
            first = _flat(p)
    want = (STEP_LAUNCHES if mode == "dp_wp"
            else {k: 0 for k in STEP_LAUNCHES})
    if any(c != want for c in launches):
        raise AssertionError(f"phase 12 {mode} {shape} rank {mesh.rank}: "
                             f"launches a step {launches}, expected {want}")
    out = {"case": f"{mode} {shape}", "digest": _digest(p, s, o),
           "step_ms": float(np.median(times)), "batch": batch,
           "launches": launches[0],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # the ranks give back their cached blocks before rank 0 runs the
    # plain step on the global batch (the processes share one card)
    torch.cuda.empty_cache()
    dist.barrier(group=mesh.world.group)
    if mesh.rank == 0:
        plain = make_train_step(microbatches=mb)
        v0, bn0, g0 = plain.loss_and_grads(_clone(params0), _clone(state0),
                                           x)
        a, b = _flat(g0), _flat(g)
        out.update(
            loss=float(v), plain_loss=float(v0),
            loss_rel=abs(float(v) - float(v0)) / abs(float(v0)),
            grad_cos=float(a @ b / (a.norm() * b.norm())),
            grad_rel=float((a - b).norm() / a.norm()),
            bn_max_abs=float((_flat(bn0) - _flat(bn)).abs().max()))
        p1, _, _, _ = plain(_clone(params0), _clone(state0),
                            adam_init(params0), x, LR)
        u0, u1 = _flat(p1) - _flat(params0), first - _flat(params0)
        out["update_same_sign"] = float(
            (torch.sign(u0) == torch.sign(u1)).double().mean())
        # an update is at most lr, plus the rounding of the stored
        # float32 parameter (half an ulp, 2^-24 |p|, each way)
        out["update_excess"] = float((u1.abs() - LR - _flat(params0).abs()
                                      * 2.0 ** -23).max())
        del p1, u0, u1
    dist.barrier(group=mesh.world.group)
    del p, s, o, g, bn, params0, state0, first
    torch.cuda.empty_cache()
    return out


def phase12_rank(rank, world, url, backend, device, q, hw=H) -> None:
    """One rank of a phase-12 world: every case of PAR_CASES that fits
    the world, then its results on ``q``."""
    # several processes share the card: grow segments instead of caching
    # fixed blocks, so one process's freed memory is another's
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from onet_tpu_torch.parallel import multihost

    dev = multihost.initialize(url, world, rank, device=device,
                               backend=backend)
    out = [_par_case(c, dev, hw) for c in PAR_CASES
           if int(np.prod(c[1])) <= world]
    q.put((rank, out))
    dist.destroy_process_group()


def many_rank_world(world: int, backend: str, device, hw: int = H) -> list:
    """Phase 12 (b)/(c): a world of ``world`` spawned processes; returns
    rank 0's case results after checking every rank's. ``hw``: the
    frames' side (512; smaller to rehearse on the CPU)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    os.makedirs(PHASE12_DIR, exist_ok=True)
    url = "file://" + os.path.join(PHASE12_DIR, f"rdv_{backend}_{world}")
    if os.path.exists(url[7:]):
        os.remove(url[7:])
    procs = [ctx.Process(target=phase12_rank,
                         args=(r, world, url, backend, device, q, hw))
             for r in range(world)]
    for pr in procs:
        pr.start()
    got = {}
    deadline = time.perf_counter() + 600
    try:
        while len(got) < world:
            try:
                rank, out = q.get(timeout=5)
                got[rank] = out
            except queue.Empty:
                dead = [pr.exitcode for pr in procs
                        if pr.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(
                        f"phase 12 world {world} {backend}: ranks exited "
                        f"{[pr.exitcode for pr in procs]} before answering")
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.kill()
    bad = [pr.exitcode for pr in procs if pr.exitcode != 0]
    if bad:
        raise AssertionError(f"phase 12 world {world} {backend}: rank exit "
                             f"codes {[pr.exitcode for pr in procs]}")
    rows = []
    for i, r0 in enumerate(got[0]):
        n = int(np.prod(PAR_CASES[i][1]))
        digests = {got[r][i]["digest"] for r in range(n)}
        line = (f"[par] world {world} {backend}, {torch.cuda.device_count()}"
                f" card(s): {r0['case']} batch {r0['batch']}: loss "
                f"{r0['loss']:.7f} (plain {r0['plain_loss']:.7f}, relative "
                f"{r0['loss_rel']:.2e}); gradient cosine {r0['grad_cos']:.8f}"
                f", relative L2 {r0['grad_rel']:.2e}; BN state max abs "
                f"{r0['bn_max_abs']:.2e}; first update's signs as the "
                f"plain step's {r0['update_same_sign']:.6f}, largest "
                f"beyond lr {r0['update_excess']:.2e}; ranks bit-equal "
                f"{len(digests) == 1}; pair-packed launches a step "
                f"{r0['launches']}; step {r0['step_ms']:.1f} ms "
                f"(rank 0, median of {PAR_STEPS}), peak "
                f"{max(got[r][i]['peak_gib'] for r in range(n)):.2f} GiB a "
                f"rank")
        log(line)
        if len(digests) != 1 or not (
                r0["loss_rel"] <= 1e-5 and r0["grad_cos"] > 0.9999
                and r0["grad_rel"] < 1e-3 and r0["bn_max_abs"] <= 1e-4
                and r0["update_same_sign"] > 0.99
                and r0["update_excess"] <= LR * 1e-3):
            raise AssertionError(f"phase 12: {line}")
        rows.append(dict(r0, world=world, backend=backend,
                         ranks_bit_equal=True,
                         step_ms_by_rank=[got[r][i]["step_ms"]
                                          for r in range(n)]))
    return rows


def parallel_workload(TC, dev, trained) -> dict:
    """Phase 12: (a) the one-rank NCCL world in this process; (b) gloo
    worlds of 2 and 4 processes sharing the card (times there are not
    multi-GPU numbers: the processes share one card and the collectives go
    through the host); (c) where the host has two or more cards, NCCL over
    min(4, count) of them."""
    res = {"a": one_rank_world(TC, dev, trained)}
    torch.cuda.empty_cache()
    log(f"[par] this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB before the "
        "many-rank worlds start")
    res["b"] = many_rank_world(4, "gloo", "cuda:0")
    count = torch.cuda.device_count()
    if count >= 2:
        n = min(4, count)
        res["c"] = many_rank_world(n, "nccl", None)
        dp = next(r for r in res["c"] if r["case"].startswith("dp"))
        ranks = len(dp["step_ms_by_rank"])
        res["c_dp_frames_per_s"] = sum(
            dp["batch"] / ranks / ms * 1e3 for ms in dp["step_ms_by_rank"])
        log(f"[par] (c) NCCL on {n} cards: DP step frames/s summed over "
            f"ranks {res['c_dp_frames_per_s']:.1f}")
    else:
        log(f"[par] (c) skipped: {count} card on this host (NCCL takes one "
            "rank per card)")
    shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 13: the command line, its libraries and the one-command reproduction
# ---------------------------------------------------------------------------

PHASE13_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runs", "chip_smoke_phase13")
CLI_REQUESTS = 3                 # POST /segment requests of 8 frames, 512^2
SERVE_LAUNCHES = {"conv3x3_wp": 2, "conv3x3_wp2": 1}   # a folded batch
PROFILE_STEPS = 5                # StepTimer's steps of phase 4's step


def reproduce_expect(S) -> dict:
    """Each reproduction stage's launches of the pair-packed kernels at
    scale ``S``, from its train steps and unfolded forwards (``expect``):
    the simclutter driver's steps and evals (every ``eval_every`` epochs and
    the last) over its 90/10 split, a forward per batch of the sweeps
    (batch 10 a level, two models), the two-stage pass (two forwards a batch
    of ``batch``), the NAU transfer (10 frames, batch 5; 200^2 takes the
    kernels), the ZY-3 driver (an eval each epoch and the report's, batch 4)
    and one forward of the variant stack a scene in the on-ramp choice."""
    from onet_tpu_torch.data.arrays import num_batches

    def sim(levels):
        n = len(levels) * S["frames"]
        n_train = int(n * 0.9)
        evals = sum(e % S["eval_every"] == 0 or e == S["sim_epochs"] - 1
                    for e in range(S["sim_epochs"]))
        return expect(evals * num_batches(n - n_train, S["batch"]),
                      S["sim_epochs"] * num_batches(n_train, S["batch"]))

    zb = min(4, S["batch"])
    n_train, n_test = S["zy3_n"]
    return {"gen_data": expect(0), "sim_low": sim(range(0, 3)),
            "sim_high": sim(range(5, 11)),
            "sweep": expect(2 * 11 * num_batches(S["sweep_frames"], 10)),
            "two_stage": expect(2 * 11 * num_batches(S["sweep_frames"],
                                                     S["batch"])),
            "nau": expect(num_batches(10, 5)),
            "zy3": expect((S["zy3_epochs"] + 1) * num_batches(n_test, zb),
                          S["zy3_epochs"] * num_batches(n_train, zb)),
            "choose_preprocess": expect(S["scenes"])}


def cli_reproduce(TC, res) -> str:
    """Phase 13 (a): ``run reproduce --scale smoke`` on the card, the
    pair-packed kernels' launches counted per stage and held to
    ``reproduce_expect``; both reports read back. Returns the newest
    simclutter milestone it saved (for (c))."""
    import glob

    from onet_tpu_torch.run import main
    from onet_tpu_torch.runs import reproduce_all as RA

    out = os.path.join(PHASE13_DIR, "reproduce_smoke")
    per_stage = {}
    real_stage = RA._stage

    def counted(report, name, fn):
        torch.cuda.synchronize()
        reset_counts(TC)
        rec = real_stage(report, name, fn)
        torch.cuda.synchronize()
        per_stage[name] = launch_counts(TC)
        return rec

    RA._stage = counted
    try:
        t0 = time.perf_counter()
        main(["reproduce", "--scale", "smoke", "--device", "cuda", "--out",
              out])
        wall = time.perf_counter() - t0
    finally:
        RA._stage = real_stage
    with open(os.path.join(out, "reproduce.json")) as f:
        rep = json.load(f)
    with open(os.path.join(out, "REPRODUCE.md")) as f:
        md = f.read()
    want = reproduce_expect(RA.SCALES["smoke"])
    seconds = {k: v["seconds"] for k, v in rep["stages"].items()}
    log(f"[cli] reproduce --scale smoke: {wall:.1f} s; stage seconds "
        f"{seconds}; backend {rep['backend']}")
    for name, got in per_stage.items():
        log(f"[cli]   {name}: launches {got}")
    if tuple(rep["stages"]) != tuple(RA.ANCHORS) or \
            tuple(per_stage) != tuple(RA.ANCHORS):
        raise AssertionError(f"stages {list(rep['stages'])}")
    if per_stage != want:
        bad = {k: (per_stage[k], want[k]) for k in want
               if per_stage[k] != want[k]}
        raise AssertionError(f"reproduce launches (got, want): {bad}")
    if rep["backend"] != torch.cuda.get_device_name(0) or \
            rep["params"] != json.loads(json.dumps(RA.SCALES["smoke"])):
        raise AssertionError(f"report header {rep['backend']} "
                             f"{rep['params']}")
    for name in ("gen-data", "simclutter PSNR0-2", "per-PSNR verify",
                 "two-stage", "NAU transfer",
                 f"zy3 ({RA.SCALES['smoke']['zy3_epochs']} epochs)",
                 "preprocess selection"):
        if name not in md:
            raise AssertionError(f"REPRODUCE.md lacks {name!r}")
    for s in ("sim_low", "sim_high", "zy3"):
        e = rep["stages"][s]["final_eval"]
        if not all(0.0 <= e[k] <= 1.0 for k in ("acc", "miou", "dr", "far")):
            raise AssertionError(f"{s} final eval {e}")
    res["reproduce"] = dict(wall_s=wall, stage_s=seconds,
                            launches=per_stage,
                            methods=rep["stages"]["nau"]["methods"])
    found = glob.glob(os.path.join(out, "sim_clutter", "*_epoch_*.npz"))
    return max(found, key=os.path.getmtime)


def cli_summary(res) -> None:
    """Phase 13 (b): ``run summary`` on the card (base 64, 224^2) and on
    the CPU, line for line."""
    from onet_tpu_torch.run import main

    outs = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["summary", "--device", dev])
        outs[dev] = buf.getvalue().splitlines()
    log("[cli] summary on the card: " + " | ".join(outs["cuda"][:2]
                                                   + outs["cuda"][-1:]))
    if outs["cuda"] != outs["cpu"] or outs["cuda"][0] != "params: 31.04 M":
        raise AssertionError(f"summary card vs CPU: {outs}")
    res["summary_lines"] = len(outs["cuda"])


def _cli_serve(argv, requests, frames_in, TC=None):
    """``run serve ... --http 0`` in a thread; ``requests`` POST /segment
    of ``frames_in``. Returns (masks of each request, launches of the
    pair-packed kernels during the requests, wall ms of each)."""
    from onet_tpu_torch.run import main
    from onet_tpu_torch.serve import http

    bound = threading.Event()
    real = http.start_server
    url = {}

    def start(sess, port):
        server = real(sess, port)
        url["u"] = f"http://127.0.0.1:{server.server_address[1]}"
        torch.cuda.synchronize()
        if TC is not None:
            reset_counts(TC)
        bound.set()
        return server

    http.start_server = start
    th = threading.Thread(target=main, args=(argv,), daemon=True)
    try:
        th.start()
        if not bound.wait(600):
            raise AssertionError("run serve did not bind")
        masks, ms = [], []
        for _ in range(requests):
            t0 = time.perf_counter()
            masks.append(post(url["u"] + "/segment", frames_in))
            ms.append((time.perf_counter() - t0) * 1e3)
        th.join(120)
        if th.is_alive():
            raise AssertionError("run serve did not exit after its requests")
    finally:
        http.start_server = real
    return masks, None if TC is None else launch_counts(TC), ms


def cli_serve(TC, dev, res, ckpt: str) -> None:
    """Phase 13 (c): ``run serve --http 0 --http-requests 3`` on the
    reproduction's checkpoint, 8 frames at 512^2 a request, the masks
    against a direct ``onet_infer`` and the launches counted; then
    ``export-artifact`` and ``serve`` of the artifact, one request, against
    the artifact's own call."""
    from onet_tpu_torch.core.checkpoint import load_onet_auto
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.run import main
    from onet_tpu_torch.serve.artifact import load_serving_artifact

    x = frames(8, SEED + 90)
    inp = os.path.join(PHASE13_DIR, "frames.npz")
    np.savez(inp, imgs=x)
    common = ["--input", inp, "--serve-batch", "8", "--http", "0",
              "--device", "cuda"]
    masks, launches, ms = _cli_serve(
        ["serve", "--model", ckpt, "--http-requests", str(CLI_REQUESTS)]
        + common, CLI_REQUESTS, x, TC)
    want = {k: 0 for k in launch_counts(TC)}
    want.update({k: v * CLI_REQUESTS for k, v in SERVE_LAUNCHES.items()})
    params, state, _ = load_onet_auto(ckpt, dev)
    with torch.inference_mode():
        direct = onet_infer(fold_onet(params, state),
                            torch.from_numpy(x).to(dev),
                            policy=BF16_COMPUTE)[1].cpu().numpy()
    same = [bool(np.array_equal(m, direct)) for m in masks]
    log(f"[cli] serve --http: {CLI_REQUESTS} requests of 8 frames at "
        f"{H}x{W}, ms {[round(v, 2) for v in ms]}, launches {launches}, "
        f"masks equal to onet_infer {same}, foreground share "
        f"{float(direct.mean()):.4f}")
    if launches != want or not all(same):
        raise AssertionError(f"run serve: launches {launches} (want {want})"
                             f", masks equal {same}")

    art = os.path.join(PHASE13_DIR, "model.onetx")
    t0 = time.perf_counter()
    main(["export-artifact", "--model", ckpt, "--out", art, "--input-sz",
          str(H), "--device", "cuda"])
    export_s = time.perf_counter() - t0
    amasks, _, ams = _cli_serve(["serve", "--model", art,
                                 "--http-requests", "1"] + common, 1, x)
    call, meta = load_serving_artifact(art, dev)
    acall = call(torch.from_numpy(x).to(dev))[1].cpu().numpy()
    agree = float((amasks[0] == direct).mean())
    log(f"[cli] export-artifact {export_s:.1f} s ({meta['arithmetic']}, "
        f"{meta['device']}); serve of the artifact: {ams[0]:.2f} ms, masks "
        f"equal to the artifact's call {np.array_equal(amasks[0], acall)}, "
        f"agreement with the live pair-packed masks {agree:.6f}")
    if not np.array_equal(amasks[0], acall):
        raise AssertionError("served artifact masks differ from its call")
    res["serve"] = dict(request_ms=ms, launches=launches,
                        export_s=export_s, artifact_request_ms=ams[0],
                        artifact_vs_live=agree)


def cli_profile(dev, res, trained) -> None:
    """Phase 13 (d): ``utils/profiling`` on phase 4's pair-packed step
    (512^2, batch 8, bf16): ``trace`` + ``category_breakdown`` of one step,
    the eager elementwise share, and ``StepTimer`` over PROFILE_STEPS
    steps beside phase 4's CUDA-event step time."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step
    from onet_tpu_torch.utils.profiling import (StepTimer, category_breakdown,
                                               hlo_breakdown, trace)

    gen = torch.Generator().manual_seed(SEED + 20)
    params, state = O.onet_init(gen, 1, base=64, device=dev)
    opt = adam_init(params)
    x = torch.from_numpy(frames(8, SEED + 30)).to(dev)
    with pair_pack(O, True):
        step = make_train_step(policy=BF16_COMPUTE)
        for _ in range(2):
            params, state, opt, loss = step(params, state, opt, x, LR)
        StepTimer.sync(loss)
        logdir = os.path.join(PHASE13_DIR, "trace")
        with trace(logdir):
            params, state, opt, loss = step(params, state, opt, x, LR)
            StepTimer.sync(loss)
        timer = StepTimer(dev)
        for _ in range(PROFILE_STEPS):
            params, state, opt, loss = step(params, state, opt, x, LR)
        step_s = timer.stop(loss, steps=PROFILE_STEPS)
    cats = category_breakdown(logdir)
    total = sum(cats.values())
    top = hlo_breakdown(logdir, top=6)
    log(f"[cli] profiled step (device ms by category, {total:.2f} ms in "
        "all): " + ", ".join(f"{k} {v:.2f}" for k, v in cats.items()))
    log(f"[cli]   elementwise share {cats.get('elementwise', 0) / total:.3f}"
        f"; top kernels: " + "; ".join(
            f"{r['name'][:60]} {r['total_ms']:.2f} ms x{r['occurrences']} "
            f"({r['category']})" for r in top))
    log(f"[cli] StepTimer: {step_s * 1e3:.2f} ms a step over "
        f"{PROFILE_STEPS} steps; phase 4's CUDA-event step "
        f"{trained['train_b8_wp_step_ms']:.2f} ms")
    if not cats or cats.get("hand-written", 0) <= 0 or not step_s > 0:
        raise AssertionError(f"profile categories {cats}")
    res["profile"] = dict(categories_ms=cats, device_ms=total,
                          elementwise_share=cats.get("elementwise", 0) / total,
                          steptimer_ms=step_s * 1e3,
                          phase4_ms=trained["train_b8_wp_step_ms"])


def cli_refusals(res) -> None:
    """Phase 13 (e): ``bench`` and ``simclutter --dp 2`` exit with their
    messages, before any work."""
    from onet_tpu_torch.run import main

    said = {}
    for argv, word in ((["bench"], "benchmark"),
                       (["simclutter", "--dp", "2", "--device", "cuda"],
                        "Queue A item 7")):
        try:
            main(argv)
        except SystemExit as e:
            said[argv[0]] = str(e)
        if word not in said.get(argv[0], ""):
            raise AssertionError(f"{argv}: {said.get(argv[0])!r}")
    log(f"[cli] refusals: {said}")
    res["refusals"] = said


def cli_workload(TC, dev, trained) -> dict:
    """Phase 13: the command line (``onet_tpu_torch/run.py``) in this
    process, pair-packed, on the card: (a) the reproduction at the smoke
    scale, (b) summary, (c) serve over HTTP and the artifact, (d) the
    profiling tools on phase 4's step, (e) the refusals."""
    from onet_tpu_torch.models import onet as O

    res = {}
    os.makedirs(PHASE13_DIR, exist_ok=True)
    try:
        with pair_pack(O, True):
            t0 = time.perf_counter()
            ckpt = cli_reproduce(TC, res)
            res["a_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            cli_summary(res)
            t0 = time.perf_counter()
            cli_serve(TC, dev, res, ckpt)
            res["c_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            cli_profile(dev, res, trained)
            cli_refusals(res)
    finally:
        shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card", file=sys.stderr)
        return 2
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.models import onet as O
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
    ptxas_report(_build, "conv_i8")

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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    os.makedirs(PHASE9_DIR, exist_ok=True)
    os.makedirs(PHASE10_DIR, exist_ok=True)
    os.makedirs(PHASE11_DIR, exist_ok=True)
    ckpt = shutil.copy(newest_checkpoint(sim["out_root"]), PHASE9_DIR)
    ckpt10 = shutil.copy(ckpt, PHASE10_DIR)
    ckpt11 = shutil.copy(ckpt, PHASE11_DIR)
    with pair_pack(O, True):
        try:
            det = detection_workload(TC, dev, sim["out_root"])
        finally:
            shutil.rmtree(sim["out_root"])
    det["phase_s"] = time.perf_counter() - t0
    log("[detect] " + json.dumps({k: v for k, v in det.items()
                                  if k not in ("threshold_sweep",
                                               "two_stage")}))
    log(f"[detect] on {card}: " + "; ".join(
        f"{k} {v['wall_s']:.2f} s ({v['frames_per_s']:.1f} frames/s)"
        for k, v in det["steps"].items()))
    log(f"[phase7] phase took {det['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with pair_pack(O, True):
        zy3 = zy3_workload(TC, dev)
    zy3["phase_s"] = time.perf_counter() - t0
    log("[zy3] " + json.dumps(zy3))
    steady = zy3["epochs"][1:] or zy3["epochs"]
    log(f"[zy3] ZY-3 driver, {ZY3_SIZE}x{ZY3_SIZE} RGB batch 5 bf16 "
        f"pair-packed, aug on: "
        f"{np.median([e['frames_per_s'] for e in steady]):.1f} frames/s over "
        f"epochs 1-{ZY3_EPOCHS - 1}, epoch "
        f"{np.median([e['train_ms'] for e in steady]) / 1e3:.3f} s, eval "
        f"{np.median([e['eval_ms'] for e in steady]) / 1e3:.3f} s, host "
        f"share {np.median([e['host_share'] for e in steady]):.3f}; step "
        f"{zy3['step_ms']:.3f} ms + augmentation {zy3['aug_ms']:.3f} ms; on "
        f"{card}")
    log(f"[phase8] phase took {zy3['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    surf = serving_surfaces(TC, dev, ckpt)
    surf["phase_s"] = time.perf_counter() - t0
    log("[surfaces] " + json.dumps(surf))
    log(f"[surfaces] tiled 2000x3000 scene over HTTP, bf16 pair-packed, "
        f"tile {TILE} halo {HALO} batch {SCENE_BATCH}: p50 "
        f"{surf['scene_request_ms_p50']:.2f} ms "
        f"({surf['scene_mp_per_s']:.2f} megapixels/s), infer_tiled alone "
        f"{surf['tiled_scene_ms']:.2f} ms, idle share "
        f"{surf['tiled_scene_profile']['idle_share']:.3f}; tiled/whole "
        f"agreement {surf['tiled_vs_whole']:.6f}; artifact step "
        f"{surf['artifact_step_ms']:.3f} ms vs live stacked "
        f"{surf['live_stacked_step_ms']:.3f} ms; on {card}")
    log(f"[phase9] phase took {surf['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        q8 = int8_workload(dev, ckpt10)
    finally:
        shutil.rmtree(PHASE10_DIR, ignore_errors=True)
    q8["phase_s"] = time.perf_counter() - t0
    log("[int8] " + json.dumps(q8))
    log(f"[int8] 512x512 batch 8: int8 (bf16 head) "
        f"{q8['b8_int8_bf16head_step_ms']:.3f} ms, int8 "
        f"{q8['b8_int8_step_ms']:.3f} ms, bf16 stacked "
        f"{q8['b8_bf16_stacked_step_ms']:.3f} ms, bf16 pair-packed "
        f"{q8['b8_bf16_wp_step_ms']:.3f} ms; mask agreement "
        f"{q8['agreement']}; train step ms {q8['train_step_ms']}; on {card}")
    log(f"[phase10] phase took {q8['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        fam = families_workload(dev, ckpt11)
    finally:
        shutil.rmtree(PHASE11_DIR, ignore_errors=True)
    fam["phase_s"] = time.perf_counter() - t0
    log("[families] " + json.dumps(fam))
    log(f"[families] on {card}: " + "; ".join(
        f"{k} zy3 step {fam[k]['zy3_step']['step_ms']:.2f} ms "
        f"({fam[k]['zy3_step']['frames_per_s']:.1f} frames/s, idle "
        f"{fam[k]['zy3_step']['idle_share']:.3f}), 512^2 forward "
        f"{fam[k]['serve_512']['ms']:.2f} ms" for k in FAMILIES))
    log(f"[phase11] phase took {fam['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    par = parallel_workload(TC, dev, trained)
    par["phase_s"] = time.perf_counter() - t0
    log("[parallel] " + json.dumps(par))
    log(f"[phase12] phase took {par['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = cli_workload(TC, dev, trained)
    cli["phase_s"] = time.perf_counter() - t0
    log("[cli] " + json.dumps(cli))
    log(f"[phase13] phase took {cli['phase_s']:.1f} s on {card}")

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
    # phase 7's launches (steps 1-4: eval forwards, and train_by_snr's
    # steps) and the largest errors of its eval forwards at the new shapes
    # (N=10 at 200^2, N=20 and N=300 at 224^2)
    dl = det["launches"]
    det_launches = {"conv3x3_wp+stats": dl["conv3x3_wp+stats"],
                    "conv3x3_wp2+stats": dl["conv3x3_wp2+stats"],
                    "conv3x3_wp+dx": dl["conv3x3_wp"] - dl["conv3x3_wp+stats"],
                    "conv3x3_wp_dw": dl["conv3x3_wp_dw"]}
    for row in rows:
        if row["name"] in det_launches:
            row["detect_launches"] = det_launches[row["name"]]
            if row["name"] in det["kernel_errs"]:
                row["detect_max_abs_err"] = det["kernel_errs"][row["name"]]
    # phase 8's launches in the ZY-3 train() (the eval calls' apart) and
    # the largest errors of one ZY-3 step (N=10), eval forward (N=10) and
    # oracle-scoring forward (N=18)
    zl = zy3["launches"]
    zy3_launches = {"conv3x3_wp+stats": zl["conv3x3_wp+stats"],
                    "conv3x3_wp2+stats": zl["conv3x3_wp2+stats"],
                    "conv3x3_wp+dx": zl["conv3x3_wp"] - zl["conv3x3_wp+stats"],
                    "conv3x3_wp_dw": zl["conv3x3_wp_dw"]}
    for row in rows:
        if row["name"] in zy3_launches:
            row["zy3_launches"] = zy3_launches[row["name"]]
            row["zy3_max_abs_err"] = zy3["kernel_errs"][row["name"]]
    # phase 9's launches through the tiled path: the three scene requests
    # and the RGB scene (the serving epilogue at 576^2 windows, N=16), and
    # the largest error of one window batch's launches
    for row in rows[:len(KERNELS)]:
        row["scene_launches"] = sum(
            c[row["name"]] for c in (*surf["scene_launches"].values(),
                                     surf["rgb_launches"]))
        row["scene_max_abs_err"] = surf["window_max_abs_err"]
    rows += phase5_rows
    # phase 10's int8 kernels: times at their headline sites (batch 8,
    # 512^2), launches of one served batch with the bf16 head; the train
    # step's and every site's beside them
    for name, site in Q_HEADLINE.items():
        t = q8["sites"][site]
        rows.append(dict(
            name=name, route="cuda", source="onet_tpu_torch/csrc/conv_i8.cu",
            replaces=Q_REPLACES[name], site=site,
            launches=q8["launches"]["True"][name],
            max_abs_err=q8["max_abs_err"],
            **{k: t[k] for k in ("ms", "device_ms", "warm_ms", "wrapper_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "library_device_ms")},
            train_launches_per_step=(q8["train_launches_per_step"]
                                     if name == "conv3x3_i8" else 0),
            sites={k: {"ms": v["ms"], "device_ms": v["device_ms"],
                       "bound_ms": v["bound_ms"], "plain_ms": v["plain_ms"],
                       "library_ms": v["library_ms"],
                       "launches": v["launches"]}
                   for k, v in q8["sites"].items()
                   if k.endswith(".up") == (name == "convT2x2_i8")}))
    # phase 12's launches a step of the data-parallel pair-packed step on
    # the one-rank NCCL mesh (asserted equal to phase 4's STEP_LAUNCHES)
    for row in rows:
        if row["name"] in par["a"]["wp_launches"]:
            row["parallel_launches_per_step"] = \
                par["a"]["wp_launches"][row["name"]]
    # phase 13's launches through the command line: the reproduction's
    # stages (train steps and unfolded forwards) and run serve's requests
    rl = {k: sum(st[k] for st in cli["reproduce"]["launches"].values())
          for k in launch_counts(TC)}
    cli_launches = {"conv3x3_wp+stats": rl["conv3x3_wp+stats"],
                    "conv3x3_wp2+stats": rl["conv3x3_wp2+stats"],
                    "conv3x3_wp+dx": rl["conv3x3_wp"] - rl["conv3x3_wp+stats"],
                    "conv3x3_wp_dw": rl["conv3x3_wp_dw"]}
    for row in rows:
        if row["name"] in cli_launches:
            row["reproduce_launches"] = cli_launches[row["name"]]
    for row in rows[:len(KERNELS)]:
        row["cli_serve_launches"] = cli["serve"]["launches"][row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
