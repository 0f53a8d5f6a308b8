"""Tiny versions of the benchmark's cells for CPU tests: base 8, 32^2,
batches of 4, the real configuration's limits."""

from __future__ import annotations

import time

import torch

from benchmark import harness

TRAIN = "onet64-bf16.train-512-b24"
SERVE_BF16 = "onet64-bf16.serve-512-b32"
SERVE_INT8 = "onet64-int8.serve-512-b32"
REQUESTS = "onet64-bf16.requests-512x8-poisson"
SEED = 2 ** 31 + 12345


def tiny(cell: str, **cfg_over):
    bench = harness.load_benchmark()
    wl, ce = harness.find_cell(bench, cell)
    cfg = harness.load_config(ce)
    mix = harness.load_mix(wl["traffic"])
    cfg.update(base=8, input_hw=[32, 32], calibration_frames=4, **cfg_over)
    mix.update(pool=16, epochs=4)
    if "batch" in mix:
        mix["batch"] = 4
    if "session_batch" in mix:
        mix.update(session_batch=4, frames_per_request=4, rate_per_s=20.0,
                   wait_s=10.0, check_requests=4)
    if "check_frames" in mix:
        # 16 of the served frames: a fault in half of each batch shows in
        # the sample but for a chance of 2^-16
        mix["check_frames"] = 16
    return bench, cfg, mix


def run(cell: str, seed: int = SEED, seconds: float = 0.3, **cfg_over):
    bench, cfg, mix = tiny(cell, **cfg_over)
    return harness.run_cell(cell, seed, seconds, False,
                            t_start=time.perf_counter(), device="cpu",
                            bench=bench, cfg=cfg, mix=mix)


def context(cell: str, seed: int = SEED, **cfg_over):
    _, cfg, mix = tiny(cell, **cfg_over)
    return harness.Context(cell=cell, cfg=cfg, mix=mix, seed=seed,
                           seconds=0.3, trace=False,
                           device=torch.device("cpu"), tmpdir="/tmp")
