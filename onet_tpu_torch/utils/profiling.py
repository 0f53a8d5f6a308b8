"""Profiling and step-timing utilities (``onet_tpu/utils/profiling.py``).

The reference's only observability was ``time.perf_counter`` prints and a
forward-hook FLOP summary (utils_20231218.py:692-811, covered statically by
utils/summary.py). Here, as in the JAX package:

* ``StepTimer`` — step timing that ends on a real read of a value the
  timed work produced. On the card it times with CUDA events recorded on
  the current stream; on the CPU with ``time.perf_counter``.
* ``trace`` — context manager around ``torch.profiler`` writing a Chrome
  trace (``trace.json``) into a directory.
* ``hlo_breakdown`` — the trace as a per-kernel time table, each kernel
  in a class by its name (``kernel_category``: hand-written, nccl,
  cudnn/cublas, copy, reduction, elementwise, other);
  ``category_breakdown`` sums it per class.
  This is the per-op breakout of eager work: on the card the rows are the
  device's kernels and copies; a trace without device records (a CPU run)
  gives the outermost host operators instead, in category "host".
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time
from typing import Any, Dict, List

import torch

from onet_tpu_torch.core.device import resolve_device

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
TRACE_FILE = "trace.json"

_LIBRARY = re.compile(r"cudnn|cublas|cutlass|xmma|gemm|gemv|wgrad|dgrad|"
                      r"fprop|winograd|implicit_convolve|conv2d|convolve",
                      re.I)
_COPY = re.compile(r"memcpy|memset|copy_kernel|CatArrayBatchedCopy|"
                   r"\bcopy\b|fill", re.I)
_REDUCTION = re.compile(r"reduce|welford|collect_statistics|softmax|"
                        r"\bnorm|cumsum|scan|sort|topk|argm", re.I)
_ELEMENTWISE = re.compile(r"elementwise|foreach|pointwise|vectorized",
                          re.I)


class StepTimer:
    """Times steps on ``device`` with a true sync.

    >>> t = StepTimer()
    >>> for _ in range(n):
    ...     params, state, opt, loss = step(params, state, opt, x, lr)
    >>> dt = t.stop(loss, steps=n)   # seconds/step; reads loss to sync

    The constructor performs no sync: call it right after a warm-up read.
    On the card the interval is the CUDA events' (recorded on the current
    stream), on the CPU ``perf_counter``'s."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.t0 = time.perf_counter()
        self.start = None
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    @staticmethod
    def sync(value) -> float:
        """Read the first element of ``value``'s first leaf (dict keys
        sorted, as the JAX package orders them) to the host; returns it."""
        while isinstance(value, (dict, list, tuple)):
            value = (value[sorted(value)[0]] if isinstance(value, dict)
                     else value[0])
        return float(torch.as_tensor(value).reshape(-1)[0])

    def stop(self, value: Any, steps: int = 1) -> float:
        """Sync on ``value`` and return seconds per step."""
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self.sync(value)
        if end is None:
            return (time.perf_counter() - self.t0) / max(steps, 1)
        end.synchronize()
        return self.start.elapsed_time(end) / 1e3 / max(steps, 1)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace (host operators, and the
    device's kernels where a card is present) into ``logdir/trace.json``
    (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, with_flops=True)
    prof.__enter__()
    try:
        yield logdir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def hand_written_kernels() -> frozenset:
    """The names of the port's ``__global__`` functions (``csrc/*.cu``)."""
    names = set()
    for src in glob.glob(os.path.join(CSRC, "*.cu")):
        with open(src) as f:
            text = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(",
            text))
    return frozenset(names)


def kernel_category(name: str, hand_written=None) -> str:
    """The class of a device kernel or copy record, by its name, tested
    in this order: one of the port's own kernels (``hand_written``,
    default ``hand_written_kernels()``), NCCL, cuDNN / cuBLAS / CUTLASS,
    copies and fills, reductions (BatchNorm statistics, softmax, sorts
    included), elementwise, other."""
    own = hand_written_kernels() if hand_written is None else hand_written
    if any(re.search(rf"\b{k}\b", name) for k in own):
        return "hand-written"
    if "nccl" in name.lower():
        return "nccl"
    for cat, pat in (("cudnn/cublas", _LIBRARY), ("copy", _COPY),
                     ("reduction", _REDUCTION),
                     ("elementwise", _ELEMENTWISE)):
        if pat.search(name):
            return cat
    return "other"


def _outermost(events: List[dict]) -> List[dict]:
    """The host operators no other operator of their thread encloses."""
    keep, end = [], {}
    for ev in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        key = (ev.get("pid"), ev.get("tid"))
        if ev["ts"] >= end.get(key, float("-inf")):
            keep.append(ev)
            end[key] = ev["ts"] + ev["dur"]
    return keep


def hlo_breakdown(logdir_or_trace: str, top: int = 20) -> List[Dict[str, Any]]:
    """Summarize a captured trace: total ms per kernel name, descending.

    Returns a list of dicts with the JAX package's keys ``name``,
    ``category``, ``total_ms``, ``occurrences``, ``gflops_per_s``,
    ``bw_gib_per_s``, ``bound_by``. Device kernels (category from
    ``kernel_category``) and copies (``bw_gib_per_s`` from the record's
    measured bandwidth) where the trace has them, else the outermost host
    operators (category "host", ``gflops_per_s`` from the profiler's FLOP
    count where it has one). What the profiler does not record is 0 or
    "": it gives no FLOPs or bytes per kernel, so nothing says what bounds
    one. Empty list when there is no trace."""
    path = logdir_or_trace
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    events = [e for e in (data.get("traceEvents", data)
                          if isinstance(data, dict) else data)
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    own = hand_written_kernels()
    rows: Dict[str, Dict[str, Any]] = {}
    for ev in device or _outermost(
            [e for e in events if e.get("cat") == "cpu_op"]):
        args = ev.get("args", {})
        r = rows.setdefault(ev["name"], {
            "name": ev["name"],
            "category": (kernel_category(ev["name"], own) if device
                         else "host"),
            "total_ms": 0.0, "occurrences": 0, "_flops": 0.0, "_gbs": []})
        r["total_ms"] += ev["dur"] / 1e3
        r["occurrences"] += 1
        r["_flops"] += float(args.get("flops", 0) or 0)
        if "memory bandwidth (GB/s)" in args:
            r["_gbs"].append(float(args["memory bandwidth (GB/s)"]))
    out = []
    for r in sorted(rows.values(), key=lambda r: -r["total_ms"])[:top]:
        flops, gbs = r.pop("_flops"), r.pop("_gbs")
        r["gflops_per_s"] = (flops / 1e9 / (r["total_ms"] / 1e3)
                             if flops and r["total_ms"] else 0.0)
        r["bw_gib_per_s"] = (sum(gbs) / len(gbs) * 1e9 / 2 ** 30
                             if gbs else 0.0)
        r["bound_by"] = ""
        out.append(r)
    return out


def category_breakdown(logdir_or_trace: str) -> Dict[str, float]:
    """Total ms per category over the whole trace."""
    rows = hlo_breakdown(logdir_or_trace, top=10 ** 6)
    agg: Dict[str, float] = {}
    for r in rows:
        agg[r["category"]] = agg.get(r["category"], 0.0) + r["total_ms"]
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]))
