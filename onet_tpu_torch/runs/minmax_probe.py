"""Timing of the min-max/complement kernel (``ops/head.py``,
``minmax_complement``) at the train batch's frames, [8, 512, 512, 1] in
f32 and bf16, on one card.

It times the kernel of whichever ``onet_tpu_torch`` it imports, so two
trees of the package compare on one card, one process each: run this file
with ``PYTHONPATH`` set to the tree whose kernel is timed::

    PYTHONPATH=. python onet_tpu_torch/runs/minmax_probe.py
    PYTHONPATH=path/to/other/tree python onet_tpu_torch/runs/minmax_probe.py

It imports only names every tree of the port since the head kernels has
(``ops.head`` and ``runs.dw_probe``'s timers). Each call is timed with the
L2 cache flushed before it, outside the CUDA events (median of
``dw_probe.REPS``), by the profiler's device time (every record counted: 2
launches a call for a tree whose library still exports
``onet_minmax_chunks``, the two-pass kernel, else 1) and by CUDA events
with the card held behind a spin kernel (no host work counts in either).
Beside it, ``torch.aminmax`` over each frame, which reads x once: a
yardstick of the read rate a one-pass reduction reaches, not a library
equivalent (it writes neither output). Every output is held to
``minmax_complement_plain``, bit for bit.

Where the tree has ``minmax_plan`` (the one-launch kernel), also:

* the set-up's plan and the kernel at K = 4, 8 and 16 CTAs a frame
  (outputs allocated once), each with the clusters the card holds at once;
* one traced call of the set-up's plan: the SMs its CTAs ran on and the
  median SM clocks of their load, exchange and write phases.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os

import torch

from onet_tpu_torch.runs.dw_probe import (PEAK_BYTES_S, card_line, cold_ms,
                                          device_ms, flush_l2, queued_ms)

SHAPE = (8, 512, 512, 1)
SWEEP = (4, 8, 16)


def times(fn, kernels) -> dict:
    return {"ms": cold_ms(fn), "device_ms": device_ms(fn, kernels=kernels),
            "queued_ms": queued_ms(fn)}


def frames(dtype):
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1981)
    return (5 * torch.rand(SHAPE, generator=gen, device=dev) - 1).to(dtype)


def traced(HD, x) -> dict:
    """One call of the set-up's plan after an L2 flush, traced."""
    yn, yc = torch.empty_like(x), torch.empty_like(x)
    k = HD.minmax_plan(x).k
    tr = torch.zeros((SHAPE[0] * k, 8), dtype=torch.int64, device=x.device)
    flush_l2(0)
    HD._minmax_launch(x, yn, yc, trace=tr)
    t = tr.cpu()
    med = lambda c: int(t[:, c].float().median())  # noqa: E731
    return {"ctas": t.shape[0], "distinct_sms": len(set(t[:, 0].tolist())),
            "span_ns": int((t[:, 2] - t[:, 1].min()).max()),
            "load_cycles": med(3), "load_cycles_max": int(t[:, 3].max()),
            "exchange_cycles": med(4), "write_cycles": med(5)}


def run_dtype(HD, dtype, kernels: int) -> dict:
    x = frames(dtype)
    rn, rc = HD.minmax_complement_plain(x)
    xn, xc = HD.minmax_complement(x)
    out = {"equal": torch.equal(xn, rn) and torch.equal(xc, rc),
           "bound_ms": 3 * x.numel() * x.element_size() / PEAK_BYTES_S * 1e3,
           "kernel": times(lambda: HD.minmax_complement(x), kernels)}
    flat = x.view(SHAPE[0], -1)
    out["aminmax"] = times(lambda: torch.aminmax(flat, dim=1), None)
    if hasattr(HD, "minmax_plan"):
        out["plan"] = HD.minmax_plan(x)._asdict()
        out["trace"] = traced(HD, x)
        yn, yc = torch.empty_like(x), torch.empty_like(x)
        for k in SWEEP:
            HD._minmax_launch(x, yn, yc, k)
            row = {**HD.minmax_plan(x, k)._asdict(),
                   "equal": torch.equal(yn, rn) and torch.equal(yc, rc)}
            row.update(times(lambda: HD._minmax_launch(x, yn, yc, k), 1))
            out[f"k{k}"] = row
    return out


def main() -> None:
    from onet_tpu_torch.ops import _build
    from onet_tpu_torch.ops import head as HD

    kernels = 2 if hasattr(_build.load("head"), "onet_minmax_chunks") else 1
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(
               HD.__file__))),
           "card": card_line(), "shape": list(SHAPE),
           "launches_per_call": kernels}
    for dtype in (torch.float32, torch.bfloat16):
        out[str(dtype)[6:]] = run_dtype(HD, dtype, kernels)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
