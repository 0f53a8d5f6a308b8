"""The traced window: torch.profiler over the window, reduced to device
busy time, each kernel's class and time, the launches that lost their
device record, and the idle gaps by what the host was doing.

Kernel classes are data: every ``kernels/*.json`` holds {"class": name,
"patterns": [regular expressions], "about": what they hold}, and the
classes are the union of all files. A kernel's class is the first class (in file-name order) with a
pattern that its name matches; a kernel no pattern matches is
"unclassified".
"""

from __future__ import annotations

import glob
import json
import os
import re
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchKernelExC|"
                    r"cudaMemcpyAsync|cudaMemsetAsync|cudaMemcpy|"
                    r"cuLaunchKernelEx|cudaLaunchCooperativeKernel)")


def kernel_classes(bench_dir: str):
    """[(class, compiled pattern)] from every kernels/*.json, in file-name
    order."""
    out = []
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels",
                                              "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        for pat in spec["patterns"]:
            out.append((spec["class"], re.compile(pat)))
    return out


def classify(name: str, classes) -> str:
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return "unclassified"


class Window:
    """Profile a window: ``with Window(trace=True) as w: ...``; after the
    block ``w.summary(classes)`` reduces the trace. With ``trace=False``
    it only times the window."""

    def __init__(self, trace: bool, tmpdir: str, device):
        self.trace = trace
        self.tmpdir = tmpdir
        self.cuda = getattr(device, "type", device) == "cuda"
        self.prof = None

    def _sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self, classes) -> dict:
        """{busy_s, window_s, by_class {class: s}, device_s, ops
        [(name, s)], gaps [(host op, s)], launches, recorded}."""
        path = os.path.join(self.tmpdir, f"bench_trace_{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return reduce_events(events, classes, self.seconds)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_events(events, classes, window_s: float) -> dict:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and "dur" in e]
    cpu = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and "dur" in e]
    runtime = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime"
               and LAUNCH.match(e.get("name", ""))]
    by_class, by_name, unclassified = {}, {}, {}
    for e in dev:
        s = e["dur"] / 1e6
        name = e["name"]
        cls = classify(name, classes)
        by_class[cls] = by_class.get(cls, 0.0) + s
        by_name[name] = by_name.get(name, 0.0) + s
        if cls == "unclassified":
            unclassified[name] = unclassified.get(name, 0.0) + s
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(b - a for a, b in merged) / 1e6
    # idle gaps between device records, named by the outermost host op
    # running at the gap's start
    outer = _outermost(cpu)
    starts = [e["ts"] for e in outer]
    gaps = {}
    for (a0, a1), (b0, _) in zip(merged, merged[1:]):
        g = (b0 - a1) / 1e6
        if g <= 0:
            continue
        name = _host_at(outer, starts, a1)
        gaps[name] = gaps.get(name, 0.0) + g
    corr_dev = {e.get("args", {}).get("correlation") for e in dev}
    lost = sum(1 for e in runtime
               if e.get("args", {}).get("correlation") not in corr_dev)
    return {"busy_s": busy, "window_s": window_s,
            "device_s": sum(by_class.values()), "by_class": by_class,
            "ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
            "unclassified": sorted(unclassified.items(),
                                   key=lambda kv: -kv[1]),
            "launches": len(runtime), "lost": lost,
            "kernels": len(dev)}


def _outermost(cpu):
    keep, end = [], {}
    for e in sorted(cpu, key=lambda e: (e["ts"], -e["dur"])):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= end.get(key, float("-inf")):
            keep.append(e)
            end[key] = e["ts"] + e["dur"]
    return keep


def _host_at(outer, starts, t):
    """The name of the latest-starting outermost host op that covers t,
    or "host (no op)"."""
    import bisect
    i = bisect.bisect_right(starts, t) - 1
    best = None
    # ops of several threads interleave: look back a little
    for j in range(i, max(i - 64, -1), -1):
        e = outer[j]
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            best = e["name"]
            break
    return best or "host (no op)"
