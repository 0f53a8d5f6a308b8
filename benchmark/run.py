"""The benchmark of the PyTorch/CUDA port, ``onet_tpu_torch``: one cell,
one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Prints as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also end standard error. Exits non-zero, printing no result,
without a CUDA device, without the port beside this folder, or when JAX
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _paths() -> None:
    """The checkout's root first on the path, so that ``benchmark`` and
    ``onet_tpu_torch`` are the ones in this checkout; kernel caches inside
    it."""
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".bench_cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, ".bench_cache",
                                       "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    wl, _ = harness.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark measures the card")
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        harness.log(f"{args.workload} needs {wl['chips']} cards, "
                    f"{torch.cuda.device_count()} present")
        return 2
    try:
        import onet_tpu_torch
    except ImportError as e:
        harness.log(f"the port is not beside the benchmark: {e}")
        return 2
    pkg = os.path.dirname(os.path.abspath(onet_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        harness.log(f"onet_tpu_torch loaded from {pkg}, not from {ROOT}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START, root=ROOT,
                              bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
