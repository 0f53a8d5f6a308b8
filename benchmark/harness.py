"""The benchmark's general part: it finds a cell's configuration, mix,
driver, metric readers and kernel classes by the names in
``BENCHMARK.json``, runs the driver's set-up, window and check, and
assembles the result line.

A cell names a configuration (``configs/<name>.json``, through the
``file`` of its entry) and a traffic mix (``mixes/<traffic>.json``);
the mix names its driver (``drivers/<driver>.py``: ``setup``, ``window``
and ``check``). A per-layer metric is read by ``metrics/<name>.py``'s
``read(rec)``, which returns a number or None where it finds nothing to
read. Kernel classes are the union of ``kernels/*.json`` (``trace.py``).
Adding any of these is adding a file. An end-to-end metric named
``<quantity>.<qualifier>`` reports the driver's ``<quantity>``: cells
that measure one quantity with different spreads get bounds of their own
by naming it apart in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "onet_tpu")
# a traced run profiles at most this much of its window: the profiler's
# records of a longer one take longer to read than a run may
TRACE_CAP_S = 5.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str):
    """(workload entry, configuration entry) of the cell ``name``."""
    for wl in bench["workloads"]:
        if wl["name"] == name:
            for cfg in bench["configs"]:
                if cfg["name"] == wl["config"]:
                    return wl, cfg
            raise KeyError(f"cell {name}: no configuration {wl['config']}")
    raise KeyError(f"no cell {name!r}; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def load_config(entry: dict, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, entry["file"]))


def load_mix(traffic: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "mixes", traffic + ".json"))


def load_module(path: str, tag: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod_name = "benchmark._loaded." + tag.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "drivers", name + ".py"),
                       "driver." + name)


def reader(metric: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "metrics", metric + ".py"),
                       "metric." + metric)


def peaks(bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "peaks.json"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer metrics (those that list the
    cell, or that list no cells and move an end-to-end metric the cell
    reports)."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's name, configuration and mix, the
    run's seed, window and trace switch, the device, and where it may
    write (``tmpdir``)."""
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmpdir: str
    bench_dir: str = BENCH_DIR

    def window(self):
        """The timed window (``trace.Window``); a traced run profiles it."""
        from benchmark.trace import Window
        return Window(self.trace, self.tmpdir, self.device)

    @property
    def window_seconds(self) -> float:
        """How long the window runs: ``seconds``, or in a traced run at
        most ``TRACE_CAP_S``."""
        return min(self.seconds, TRACE_CAP_S) if self.trace else self.seconds


def sync(device) -> None:
    import torch
    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    import torch
    if getattr(device, "type", device) != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def _reset_peak(device) -> None:
    import torch
    if getattr(device, "type", device) == "cuda":
        torch.cuda.reset_peak_memory_stats()


def judge(checks: dict) -> bool:
    """True where every number that has a limit is within it. A number
    that is not finite fails."""
    ok = True
    for value, limit in checks.values():
        if limit is None:
            continue
        if not (isinstance(value, (int, float)) and math.isfinite(value)
                and value <= limit):
            ok = False
    return ok


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, root: str = ROOT,
             bench: dict = None, cfg: dict = None, mix: dict = None,
             tmpdir: str = None) -> dict:
    """Run one cell and return the result (without the module check,
    which ``run.py`` makes once the window has closed)."""
    import torch

    bench = bench if bench is not None else load_benchmark(root)
    wl, cfg_entry = find_cell(bench, cell)
    cfg = cfg if cfg is not None else load_config(cfg_entry, root)
    mix = mix if mix is not None else load_mix(wl["traffic"])
    dev = torch.device(device or "cuda")
    ctx = Context(cell=cell, cfg=cfg, mix=mix, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=dev,
                  tmpdir=tmpdir or os.environ.get("TMPDIR", "/tmp"))
    drv = driver(mix["driver"])
    st = drv.setup(ctx)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    pre_peak = _peak(dev)
    _reset_peak(dev)
    rec = drv.window(ctx, st)
    if rec.get("summary"):
        _log_trace(rec["summary"])
    window_peak = _peak(dev)
    rec["window_peak_bytes"] = window_peak
    memory_peak = max(pre_peak, window_peak)
    rec.update(cfg=cfg, mix=mix, peaks=peaks(), cell=cell)
    checks = drv.check(ctx, st, rec)
    del st
    gc.collect()
    correct = judge(checks)

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            v = reader(m["name"]).read(rec)
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = rec["e2e"].get(m["name"],
                               rec["e2e"].get(m["name"].split(".")[0]))
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": device_info}
    if trace and rec.get("summary"):
        s = rec["summary"]
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        out["breakdown"] = {
            "device_ops": [[short_name(n), v] for n, v in s["ops"][:10]],
            "idle_gaps": [[short_name(n), v] for n, v in s["gaps"][:10]]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def short_name(name: str, width: int = 200) -> str:
    """A kernel's or host op's name for the result line: without a
    leading "void ", at most ``width`` characters."""
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def _log_trace(s: dict) -> None:
    """The traced window's reading, on earlier lines of standard error:
    device time by class, the device time no class claims (every kernel
    has to fall into one), and launches whose device record is missing."""
    log(f"[trace] window {s['window_s']:.6f} s, busy {s['busy_s']:.6f} s, "
        f"{s['kernels']} device records, {s['launches']} launches, "
        f"{s['lost']} launches without a device record")
    for cls, t in sorted(s["by_class"].items(), key=lambda kv: -kv[1]):
        log(f"[trace] class {cls}: {t:.6f} s")
    for name, t in s["unclassified"]:
        log(f"[trace] UNCLASSIFIED {t:.6f} s {name[:300]}")
    for name, t in s["ops"][:25]:
        log(f"[trace] op {t:.6f} s {name[:200]}")
    for name, t in s["gaps"][:10]:
        log(f"[trace] gap {t:.6f} s {name[:200]}")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark may not load:
    JAX, its libraries, and the JAX package (compared whole, so the
    port's name, which begins with it, is not one)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
