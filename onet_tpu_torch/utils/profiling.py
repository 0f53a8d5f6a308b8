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
* ``span`` — the program's own timed ranges: name, start and end
  (``time.perf_counter_ns``), the enclosing span of the same thread, and
  a request id (the outermost span's id, shared by every span inside
  it). Records go into one bounded ring (``RING``); ``count`` keeps
  named counters beside it. While a ``torch.profiler`` session runs,
  each record carries its ordinal (``profiled_spans`` returns the latest
  session's) and, on a thread the profiler records, the span also opens
  a ``record_function`` range, a ``user_annotation`` event of the
  Chrome trace on the profiler's clock (``trace_us`` maps a record's
  times onto it).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

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


RING = 16384


class Span(NamedTuple):
    """One closed span. ``start`` and ``end`` are ``time.perf_counter_ns``
    readings; ``parent`` is the id of the enclosing span of its thread
    (None at the top), ``request`` the id of the outermost one, and
    ``session`` the ordinal of the profiler session it ran under (None
    without one)."""
    name: str
    start: int
    end: int
    id: int
    parent: Optional[int]
    request: int
    session: Optional[int]

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


# plain tuples in Span's order; an append is atomic, so spans take no lock
_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()          # the counters and the sessions
_counters: collections.Counter = collections.Counter()
_ids = itertools.count(1)
_open = threading.local()         # each thread's stack of open spans
_session = 0                      # ordinal of the latest profiler session
_profiling = False                # whether the latest span saw one running
_offset = 0                       # its wall clock less perf_counter, ns
_thread_recorded = torch._C._autograd._profiler_enabled


def _profiler_session() -> Optional[int]:
    """The ordinal of the running profiler session, or None. The
    profiler's process-wide flag says whether one runs; a new session
    begins where a span finds it on after a span found it off (``trace``
    also begins one), so two profiled stretches with no span between
    them count as one."""
    global _session, _profiling, _offset
    if not getattr(_autograd_profiler, "_is_profiler_enabled", False):
        _profiling = False
        return None
    if not _profiling:
        with _lock:
            if not _profiling:
                _session += 1
                _offset = time.time_ns() - time.perf_counter_ns()
                _profiling = True
    return _session


class span:
    """``with span("session.step"): ...`` records the block's times into
    the ring when it closes. With the profiler off it costs a few clock
    and flag reads and one append. With it on, on a thread the profiler
    records (the one that started it), the block is also a
    ``record_function`` range, opened before the record's start is read
    and closed before its end is: the two differ at each end by what
    opening or closing a range costs, tens of us."""

    __slots__ = ("name", "start", "end", "id", "parent", "request",
                 "session", "_range", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else None
        self.request = outer.request if outer else self.id
        self.session = _profiler_session()
        self._range = None
        if self.session is not None and _thread_recorded():
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self._stack = stack
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.end = time.perf_counter_ns()
        self._stack.pop()
        _ring.append((self.name, self.start, self.end, self.id, self.parent,
                      self.request, self.session))
        return False

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (kept as long as the process)."""
    with _lock:
        _counters[name] += n


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def mark() -> int:
    """An id below that of every span opened later: ``spans(since=...)``
    then returns only those."""
    return next(_ids)


def spans(since: int = 0) -> List[Span]:
    """The ring's records in the order they closed; with ``since`` (a
    ``mark()``) only those of spans opened after it."""
    while True:
        try:
            out = list(_ring)
            break
        except RuntimeError:    # a span closed while the ring was copied
            continue
    return [Span._make(r) for r in out if r[3] > since]


def profiled_spans() -> List[Span]:
    """The records of the latest profiler session; empty before one."""
    s = _session
    return [r for r in spans() if r.session == s] if s else []


def trace_us(t_ns: int, base_ns: int) -> float:
    """A record's time (``perf_counter`` ns) on the ``ts`` axis of the
    latest profiler session's Chrome trace, in us. The profiler stamps
    events with the wall clock and the file's ``ts`` is us past its
    ``baseTimeNanoseconds`` (``base_ns``); the wall clock less
    ``perf_counter`` was read when the session's first span opened."""
    return (t_ns + _offset - base_ns) / 1e3


def percentiles(values, digits: int = 3) -> Optional[Dict[str, float]]:
    """{p50, p95, max} of ``values``, rounded; None when there are none."""
    if not len(values):
        return None
    a = np.asarray(values, np.float64)
    return {"p50": round(float(np.percentile(a, 50)), digits),
            "p95": round(float(np.percentile(a, 95)), digits),
            "max": round(float(a.max()), digits)}


def summarize(records) -> Dict[str, Dict[str, float]]:
    """{name: {p50, p95, max, count}} of the records' durations, ms."""
    by_name: Dict[str, list] = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r.ms)
    return {name: {**percentiles(ms), "count": len(ms)}
            for name, ms in sorted(by_name.items())}


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace (host operators, and the
    device's kernels where a card is present) into ``logdir/trace.json``
    (Chrome trace format). It begins a new profiler session for the
    spans (``profiled_spans``)."""
    from torch.profiler import ProfilerActivity, profile

    global _profiling
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    _profiling = False
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

    Returns a list of dicts with the keys ``name``, ``category``,
    ``total_ms`` and ``occurrences``: device kernels and copies (category
    from ``kernel_category``) where the trace has them, else the
    outermost host operators (category "host"). Empty list when there is
    no trace."""
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
        r = rows.setdefault(ev["name"], {
            "name": ev["name"],
            "category": (kernel_category(ev["name"], own) if device
                         else "host"),
            "total_ms": 0.0, "occurrences": 0})
        r["total_ms"] += ev["dur"] / 1e3
        r["occurrences"] += 1
    return sorted(rows.values(), key=lambda r: -r["total_ms"])[:top]


def category_breakdown(logdir_or_trace: str) -> Dict[str, float]:
    """Total ms per category over the whole trace."""
    rows = hlo_breakdown(logdir_or_trace, top=10 ** 6)
    agg: Dict[str, float] = {}
    for r in rows:
        agg[r["category"]] = agg.get(r["category"], 0.0) + r["total_ms"]
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]))
