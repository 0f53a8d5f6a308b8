"""Driver of a training cell: the port's train step
(``train/steps.py::make_train_step`` with ``train/optim.py``'s Adam) on
batches drawn from a pool of frames resident on the device, as the
simulated-clutter driver does with ``preload``.

Set-up makes the weights and the pool from the seed and builds one train
step. It warms that step up on a throwaway copy of the weights, the
BatchNorm state and a fresh Adam state, which it then drops. The window
starts from the seed's own weights and a fresh Adam state and runs step
after step, each ending on a read of its loss, until ``seconds`` have
passed and at least three steps have run. Its first three steps, on the
first three batches of the first epoch (every row a different frame),
are the ones the check follows: the window keeps their losses and copies
of the Adam state after the first and of the weights and BatchNorm state
after the third.

The check frees the program's state, then runs the float32 reference
(``reference/onet.py``) through the same three steps from the same
weights and compares: each step's loss; each leaf's gradient norm at step
1, which the program's Adam state gives as mu / (1 - b1); each leaf's
change over the three steps; and each BatchNorm state leaf's change.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the gradient and change (they move by round-off
alone). A leaf's reading is |program norm - reference norm| over the
larger of the reference's norm of that leaf and of the median leaf.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.inputs import onet_weights
from benchmark.traffic import frames
from benchmark.work.onet import conv_work

CHECKED_STEPS = 3
# steps set-up runs on a throwaway copy, so that nothing first runs in the
# window
WARM_STEPS = 2


def _policy(precision: str):
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    return {"bf16": BF16_COMPUTE, "fp32": DEFAULT}[precision]


def batch_order(seed: int, pool: int, batch: int, epochs: int):
    """Indices [epochs * (pool // batch), batch]: each epoch a permutation
    of the pool drawn from the seed, cut into whole batches."""
    per = pool // batch
    out = np.empty((epochs * per, batch), dtype=np.int64)
    for e in range(epochs):
        perm = frames.rng(seed, 100 + e).permutation(pool)
        out[e * per:(e + 1) * per] = perm[:per * batch].reshape(per, batch)
    return out


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.detach().clone()


def setup(ctx):
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    params, state = onet_weights.make(ctx.seed, cfg["in_channels"],
                                      cfg["base"], dev)
    pool = frames.make_pool(ctx.seed, mix["pool"], cfg["input_hw"],
                            psnr=mix["psnr_db"], device=dev)
    order = torch.as_tensor(batch_order(ctx.seed, mix["pool"], mix["batch"],
                                        mix["epochs"]), device=dev)
    step = make_train_step(policy=_policy(cfg["precision"]),
                           bias=cfg.get("bias", 0.0))
    lr = mix["lr"]
    wp, ws = _clone(params), _clone(state)
    wopt = adam_init(wp)
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
    n = failed = 0
    losses, mu1, after = [], None, None
    limit = ctx.window_seconds
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
                    mu1 = _clone(opt["mu"])
                if n == CHECKED_STEPS - 1:
                    after = (_clone(params), _clone(state))
            n += 1
            if (n >= CHECKED_STEPS
                    and time.perf_counter() - w.t0 >= limit):
                break
    st.update(params=params, state=state, opt=opt,
              first=first_readings(ctx, losses, mu1, *after))
    b = ctx.mix["batch"]
    rec = {"kind": "train", "calls": n, "frames": n * b,
           "seconds": w.seconds, "attempted": n, "failed": failed,
           "e2e": {"train_frames_per_s": n * b / w.seconds},
           "work": conv_work(ctx.cfg, b, train=True)}
    if ctx.trace:
        from benchmark.trace import kernel_classes
        rec["summary"] = w.summary(kernel_classes(ctx.bench_dir))
    return rec


def first_readings(ctx, losses, mu1, params, state) -> dict:
    """The program's norms over the window's first steps: losses, each
    leaf's step-1 gradient (mu / (1 - b1)), each leaf's change from the
    seed's weights and each BatchNorm leaf's change."""
    cfg = ctx.cfg
    b1 = cfg["adam"]["b1"]
    p0, s0 = onet_weights.make(ctx.seed, cfg["in_channels"], cfg["base"],
                               ctx.device)
    d0, e0 = dict(onet_weights.leaves(p0)), dict(onet_weights.leaves(s0))
    return {"loss": losses,
            "grad": {k: float((m / (1 - b1)).norm())
                     for k, m in onet_weights.leaves(mu1)},
            "change": {k: float((v - d0[k]).norm())
                       for k, v in onet_weights.leaves(params)},
            "bn_state": {k: float((v - e0[k]).norm())
                         for k, v in onet_weights.leaves(state)}}


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's |prog - ref| over max(ref leaf, median ref leaf)."""
    keys = list(keys)
    if not keys:
        return 0.0
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def readings(first: dict, ref: dict, p0: dict, s0: dict) -> dict:
    """The compared numbers from the program's first steps and the
    reference's (``reference.onet.train_steps``)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(first["loss"], ref["loss"]))
    g = ref["grad"]
    med = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * med]
    change_ref = {k: float((ref["param"][k] - p0[k]).norm()) for k in g}
    bn_ref = {k: float((ref["state"][k] - s0[k]).norm()) for k in s0}
    return {"loss": loss,
            "grad": leaf_gap(first["grad"], g, moved),
            "change": leaf_gap(first["change"], change_ref, moved),
            "bn_state": leaf_gap(first["bn_state"], bn_ref, list(bn_ref))}


def reference_readings(ctx, st) -> dict:
    from benchmark.reference.onet import train_steps

    cfg, dev = ctx.cfg, ctx.device
    p0, s0 = onet_weights.make(ctx.seed, cfg["in_channels"], cfg["base"],
                               dev)
    batches = [st["pool"][st["order"][i]] for i in range(CHECKED_STEPS)]
    ref = train_steps(p0, s0, batches, st["lr"])
    return readings(st["first"], ref, dict(onet_weights.leaves(p0)),
                    dict(onet_weights.leaves(s0)))


def free_program(st) -> None:
    for k in ("step", "params", "state", "opt"):
        st.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(ctx, st, rec) -> dict:
    free_program(st)
    got = reference_readings(ctx, st)
    limits = ctx.cfg["limits"]["train"]
    return {k: (v, limits.get(k)) for k, v in got.items()}
