"""Cold-L2 timing of the weight-gradient kernel ``conv3x3_wp_dw`` at the
training shape (N=16 packed samples, 512x512, bf16) on one card, beside
cuDNN's weight gradient on the same inputs.

It times the kernel of whichever ``onet_tpu_torch`` it imports, so two
trees of the package compare on one card, one process each: run this file
with ``PYTHONPATH`` set to the tree whose kernel is timed::

    PYTHONPATH=. python onet_tpu_torch/runs/dw_probe.py
    PYTHONPATH=path/to/other/tree python onet_tpu_torch/runs/dw_probe.py

Every call is timed with the L2 cache flushed before it, outside the CUDA
events (the medians of ``REPS``), again by the profiler's device time and
by CUDA events with the card held behind a spin kernel (no host work
counts in either). ``*_rot`` times each call on another of ``ROT``
copies of the inputs, so no byte of a call's inputs can be left in the L2
by the call before. ``read_ms`` reads x and dy once (``amax`` of each): the
card's reachable read rate. Prints one JSON line.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess

import torch

N, H, W, C = 16, 512, 512, 64
REPS = 7
ROT = 4
FLUSH_BYTES = 256 << 20       # five times the H100's 50 MB L2
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12     # H100 SXM dense bf16 tensor cores
SPIN_CYCLES = 2_000_000       # about 1 ms of the H100's SM clock

_scratch: dict = {}


def flush_l2(i: int = 0):
    """Write FLUSH_BYTES of scratch on the current card, evicting what the
    L2 cache held; its kernel's name holds ``FillFunctor``."""
    dev = torch.cuda.current_device()
    if dev not in _scratch:
        _scratch[dev] = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                    device=dev)
    _scratch[dev].fill_(i & 0xFF)


def cold_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events after
    an L2 flush outside the events."""
    for _ in range(warmup):
        fn()
    times = []
    for i in range(reps):
        flush_l2(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median over ``reps`` single calls, each after an L2 flush, timed by
    CUDA events while the card runs a spin kernel of ``SPIN_CYCLES``
    queued before them: the host has queued the call's kernels before the
    card reaches them, so no host work counts, and the time runs from the
    call's first kernel's start to its last kernel's end (the card's own
    gaps between them included). Needs no profiler."""
    for _ in range(warmup):
        fn()
    times = []
    for i in range(reps):
        flush_l2(i)
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS, kernels: int | None = None,
              tries: int = 3) -> float | None:
    """Device time of one call from torch.profiler: the sum over its
    kernels, mean of ``reps`` calls, each after an L2 flush (the flush's
    and the spin kernels left out). No host work between the kernels
    counts.

    The mean holds only if every launch was recorded, so the records are
    counted first: ``reps * kernels`` of them where the caller states how
    many kernels one call launches, else a count of each distinct kernel
    that is a multiple of ``reps``. A spin kernel before the calls and a
    flush after them keep the calls' records off both ends of the trace.
    A short count is profiled again, up to ``tries`` times; then no mean
    is taken over the missing records and the result is None."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for i in range(reps):
                flush_l2(i)
                fn()
            flush_l2(reps)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "FillFunctor" not in e.key
               and "spin_kernel" not in e.key]
        counts = [(e.key[:60], e.count) for e in evs]
        total = sum(c for _, c in counts)
        if (total == reps * kernels if kernels is not None else
                total > 0 and all(c % reps == 0 for _, c in counts)):
            return sum(e.self_device_time_total for e in evs) / 1e3 / reps
        print(f"[device_ms] try {attempt + 1}: {total} kernel records in "
              f"{reps} calls, expected "
              f"{reps * kernels if kernels is not None else 'a multiple'} "
              f"of {reps}: {counts}", flush=True)
    return None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> None:
    from onet_tpu_torch.ops import conv_wp as TC

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1981)
    sets = [[torch.randn((N, H, W // 2, 2 * C), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2)]
            for _ in range(ROT)]
    w_lib = torch.randn((C, C, 3, 3), generator=gen, device=dev,
                        dtype=torch.bfloat16)

    def kernel(i=0):
        x, dy = sets[i % ROT]
        return TC.conv3x3_wp_dw(x, dy)

    def cudnn(i=0):
        # the packed tensors are NHWC [N, H, W, 64]: channels-last NCHW views
        x, dy = (t.view(N, H, W, C).permute(0, 3, 1, 2) for t in sets[i % ROT])
        gw = torch.ops.aten.convolution_backward(
            dy, x, w_lib, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        return gw.permute(2, 3, 1, 0)        # [co, ci, kh, kw] -> HWIO

    def read(i=0):
        x, dy = sets[i % ROT]
        return x.amax(), dy.amax()

    ref = TC.conv3x3_wp_dw_plain(*sets[0])
    top = ref.abs().max().item()
    dw = kernel(0)
    out = {
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(TC.__file__))),
        "card": card_line(),
        "shape": [N, H, W, C],
        "rel_err": (dw - ref).abs().max().item() / top,
        "deterministic": torch.equal(dw, kernel(0)),
        "cudnn_rel_err": (cudnn(0).float() - ref).abs().max().item() / top,
    }
    del ref, dw
    for name, fn in (("kernel", kernel), ("cudnn", cudnn), ("read", read)):
        out[f"{name}_ms"] = cold_ms(fn)
        calls = itertools.count()
        out[f"{name}_rot_ms"] = cold_ms(lambda: fn(next(calls)))
        out[f"{name}_device_ms"] = device_ms(
            fn, kernels=2 if name == "kernel" else None)
        out[f"{name}_queued_ms"] = queued_ms(fn)
    nbytes = 2 * N * H * W * C * 2 + 9 * C * C * 4    # x, dy in; dw out
    flops = 2 * 9 * C * C * N * H * W
    out["bound_ms"] = max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S) * 1e3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
