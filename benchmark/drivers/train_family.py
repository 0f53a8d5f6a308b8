"""Driver of a training cell for a stateless backbone family of the port
(``models/arch.py``): ``make_train_step(forward=...)`` with
``train/optim.py``'s Adam on batches drawn from a pool of frames resident
on the device.

The configuration names the family's pieces as files under
``benchmark/``, so that another family adds files and edits none:
``inputs`` makes the weights from the seed (``make(seed, cfg, device)``,
``leaves(tree)``), ``reference`` is its plain float32 reference
(``train_steps(params, batches, lr, **geometry(cfg), bias=, adam=)``) and
``work`` counts its products (``product_work(cfg, frames, train=)``).
Swin-Unet's are ``inputs/swin_weights.py``, ``reference/swin_unet.py``
and ``work/swin_unet.py``.

Set-up makes the weights and the pool from the seed, takes the family's
forward from ``get_arch(cfg["arch"], **geometry)`` and builds one train
step, which it warms up on a throwaway copy of the weights and a fresh
Adam state. The window and the check are ``drivers/train.py``'s without a
BatchNorm state: step after step from the seed's weights, each ending on
a read of its loss, until ``seconds`` have passed and at least three
steps have run; the first three are compared with the reference through
the same three steps from the same weights by ``drivers/train.py``'s
``readings``: each step's loss, each leaf's gradient norm at step 1
(mu / (1 - b1)) and each leaf's change over the three steps.

The record holds the program's counters over the window (``counters``:
each one's increase, where the program keeps them) and, in a traced run,
the device time by the program's spans (``regions``, ``regions.py``).
"""

from __future__ import annotations

import importlib
import json
import math
import os
import time

import torch

from benchmark import regions
from benchmark.harness import log
from benchmark.drivers import train
from benchmark.drivers.train import (CHECKED_STEPS, WARM_STEPS, _clone,
                                     _policy, batch_order, free_program)
from benchmark.traffic import frames


def _piece(cfg, key):
    """The module of ``benchmark/`` that the configuration names under
    ``key`` as a file path."""
    path = os.path.splitext(os.path.normpath(cfg[key]))[0]
    return importlib.import_module(path.replace(os.sep, "."))


def _weights(ctx):
    return _piece(ctx.cfg, "inputs").make(ctx.seed, ctx.cfg, ctx.device)


def _counters():
    from onet_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    return read() if read else {}


def setup(ctx):
    from onet_tpu_torch.models.arch import GEOMETRY_KEYS, get_arch
    from onet_tpu_torch.models.unet import tree_map
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    params, state = _weights(ctx)
    pool = frames.make_pool(ctx.seed, mix["pool"], cfg["input_hw"],
                            psnr=mix["psnr_db"], device=dev)
    order = torch.as_tensor(batch_order(ctx.seed, mix["pool"], mix["batch"],
                                        mix["epochs"]), device=dev)
    arch = get_arch(cfg["arch"],
                    **{k: cfg[k] for k in GEOMETRY_KEYS[cfg["arch"]]})
    step = make_train_step(forward=arch.forward,
                           policy=_policy(cfg["precision"]),
                           bias=cfg.get("bias", 0.0))
    lr = mix["lr"]
    wp = tree_map(lambda t: t.detach().clone(), params)
    ws, wopt = {k: {} for k in state}, adam_init(wp)
    for i in range(WARM_STEPS):
        wp, ws, wopt, loss = step(wp, ws, wopt, pool[order[i]], lr)
        float(loss)
    del wp, ws, wopt
    return {"step": step, "params": params, "state": state,
            "opt": adam_init(params), "pool": pool, "order": order,
            "lr": lr}


def window(ctx, st):
    step, order, pool, lr = st["step"], st["order"], st["pool"], st["lr"]
    params, state, opt = st["params"], st["state"], st["opt"]
    leaves = _piece(ctx.cfg, "inputs").leaves
    n = failed = 0
    losses, mu1, after = [], None, None
    limit = ctx.window_seconds
    before = _counters()
    with ctx.window() as w:
        while True:
            params, state, opt, loss = step(params, state, opt,
                                            pool[order[n % len(order)]], lr)
            value = float(loss)                     # the step's real read
            if not math.isfinite(value):
                failed += 1
            if n < CHECKED_STEPS:
                losses.append(value)
                if n == 0:
                    mu1 = _clone(dict(leaves(opt["mu"])))
                if n == CHECKED_STEPS - 1:
                    after = _clone(dict(leaves(params)))
            n += 1
            if (n >= CHECKED_STEPS
                    and time.perf_counter() - w.t0 >= limit):
                break
    now = _counters()
    st.update(params=params, state=state, opt=opt,
              first=first_readings(ctx, losses, mu1, after))
    b = ctx.mix["batch"]
    rec = {"kind": "train", "calls": n, "frames": n * b,
           "seconds": w.seconds, "attempted": n, "failed": failed,
           "e2e": {"train_frames_per_s": n * b / w.seconds},
           "work": _piece(ctx.cfg, "work").product_work(ctx.cfg, b,
                                                         train=True),
           "counters": {k: v - before.get(k, 0) for k, v in now.items()
                        if v != before.get(k, 0)}}
    for k, v in sorted(rec["counters"].items()):
        log(f"[counters] {k} {v} in {n} steps")
    if ctx.device.type == "cuda":
        m = torch.cuda.memory_stats(ctx.device)
        log(f"[allocator] {m['num_alloc_retries']} retries, "
            f"{m['num_device_free']} device frees since the process began")
    if ctx.trace:
        rec["summary"], rec["regions"] = traced(ctx, w)
        for k, v in sorted(rec["regions"].items(), key=lambda kv: -kv[1]):
            log(f"[regions] {k} {v:.6f} s")
    return rec


def traced(ctx, w):
    """(``trace.py``'s summary, device seconds by span) of the window's
    trace, exported once."""
    from benchmark.trace import kernel_classes, reduce_events
    path = os.path.join(ctx.tmpdir, f"bench_trace_{os.getpid()}.json")
    w.prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return (reduce_events(events, kernel_classes(ctx.bench_dir), w.seconds),
            regions.reduce(events))


def first_readings(ctx, losses, mu1, params) -> dict:
    """The program's norms over the window's first steps: losses, each
    leaf's step-1 gradient (mu / (1 - b1)) and each leaf's change from
    the seed's weights."""
    b1 = ctx.cfg["adam"]["b1"]
    p0 = dict(_piece(ctx.cfg, "inputs").leaves(_weights(ctx)[0]))
    return {"loss": losses,
            "grad": {k: float((m / (1 - b1)).norm()) for k, m in mu1.items()},
            "change": {k: float((v - p0[k]).norm())
                       for k, v in params.items()}}


def reference_first(ref, p0) -> dict:
    """The same norms of a reference run (``reference_run``): a control or
    a fault in the program's place."""
    return {"loss": ref["loss"], "grad": ref["grad"],
            "change": {k: float((v - p0[k]).norm())
                       for k, v in ref["param"].items()}}


def readings(first: dict, ref: dict, p0: dict) -> dict:
    """The compared numbers from the program's first steps and the
    reference's: ``drivers/train.py``'s, with no BatchNorm state."""
    got = train.readings({**first, "bn_state": {}}, {**ref, "state": {}},
                         p0, {})
    del got["bn_state"]
    return got


def reference_run(ctx, st, **kw):
    """The reference through the window's first three batches from the
    seed's weights; ``kw`` (``cast``, ``fault``) makes a control or a
    fault of it. Returns (its result, the weights' leaves)."""
    cfg = ctx.cfg
    ref = _piece(cfg, "reference")
    p0 = _weights(ctx)[0]
    batches = [st["pool"][st["order"][i]] for i in range(CHECKED_STEPS)]
    out = ref.train_steps(p0, batches, st["lr"], **ref.geometry(cfg),
                          bias=cfg.get("bias", 0.0), adam=cfg["adam"], **kw)
    return out, dict(_piece(cfg, "inputs").leaves(p0))


def check(ctx, st, rec) -> dict:
    free_program(st)
    ref, p0 = reference_run(ctx, st)
    got = readings(st["first"], ref, p0)
    limits = ctx.cfg["limits"]["train"]
    return {k: (v, limits.get(k)) for k, v in got.items()}
