"""Driver of a batch-serving cell: ``serve/http.py::ServingSession``
over frames resident in host memory, one batch of the session's size a
call, back to back, as ``run.py serve`` feeds recorded sweeps.

Set-up makes the weights and the frames from the seed (frames on the
device, then moved to the host), folds the BatchNorm
(``models/infer.py::fold_onet``) and, for an int8 configuration,
calibrates on the first batch and quantizes (``models/quant.py``), as
``run.py serve --int8`` does. The session is warmed on the cell's one
shape, and one real batch goes through it.

The window calls ``segment`` on batch after batch and keeps a sample of
the served frames' masks, drawn from the seed (reservoir sampling over
every frame served). The check frees the program, then runs the
reference on the sampled frames: the float32 eval-mode twin for a bf16
configuration, the re-derived int8 path (``reference/quant.py``) for an
int8 one, and compares each served label with the reference's logits
(``reference.onet.label_gap``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import log
from benchmark.inputs import onet_weights
from benchmark.traffic import frames
from benchmark.work.onet import conv_work


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = frames.rng(seed, 7)
        self.items = []
        self.seen = 0

    def offer(self, key, make):
        """Offer the next item; ``make()`` builds it only if it is kept."""
        t = self.seen
        self.seen += 1
        if t < self.k:
            self.items.append((key, make()))
        else:
            r = int(self.rng.integers(0, t + 1))
            if r < self.k:
                self.items[r] = (key, make())


def build_session(ctx, batch: int):
    """(session, host pool [N, H, W, C] float32)."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.serve.http import ServingSession

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    params, state = onet_weights.make(ctx.seed, cfg["in_channels"],
                                      cfg["base"], dev)
    pool_dev = frames.make_pool(ctx.seed, mix["pool"], cfg["input_hw"],
                                psnr=mix["psnr_db"], device=dev)
    pool = pool_dev.cpu().numpy()
    del pool_dev
    with torch.no_grad():
        folded = fold_onet(params, state)
    del params, state
    if cfg["precision"] == "int8":
        from onet_tpu_torch.models.quant import (calibrate, onet_infer_q,
                                                 quantize_folded)
        with torch.no_grad():
            scales = calibrate(folded, torch.as_tensor(pool[:batch]).to(dev))
            model_arg = quantize_folded(folded, scales)
        step = onet_infer_q
    else:
        policy = {"bf16": BF16_COMPUTE, "fp32": DEFAULT}[cfg["precision"]]

        def step(f, xb):
            return onet_infer(f, xb, policy=policy)

        model_arg = folded
    sess = ServingSession(step, model_arg, batch=batch,
                          in_channels=cfg["in_channels"],
                          mode=cfg["precision"],
                          input_hw=tuple(cfg["input_hw"]), device=dev)
    sess.warmup()
    sess.segment(pool[:batch])
    return sess, pool


def setup(ctx):
    sess, pool = build_session(ctx, ctx.mix["batch"])
    return {"sess": sess, "pool": pool}


def window(ctx, st):
    sess, pool = st["sess"], st["pool"]
    b = ctx.mix["batch"]
    nb = pool.shape[0] // b
    sample = Reservoir(ctx.mix["check_frames"], ctx.seed)
    calls = failed = 0
    limit = ctx.window_seconds
    with ctx.window() as w:
        while True:
            k = calls % nb
            try:
                masks, _ = sess.segment(pool[k * b:(k + 1) * b])
            except Exception as e:   # noqa: BLE001 — counted as failed
                failed += 1
                log(f"[serve] batch {calls} failed: {e!r}")
                masks = None
            if masks is not None:
                for j in range(b):
                    sample.offer(k * b + j, lambda m=masks[j]: m.copy())
            calls += 1
            if time.perf_counter() - w.t0 >= limit:
                break
    st["sample"] = sample.items
    done = calls - failed
    rec = {"kind": "serve", "calls": done, "frames": done * b,
           "seconds": w.seconds, "attempted": calls, "failed": failed,
           "e2e": {"serve_frames_per_s": done * b / w.seconds},
           "work": conv_work(ctx.cfg, b, train=False)}
    if ctx.trace:
        from benchmark.trace import kernel_classes
        rec["summary"] = w.summary(kernel_classes(ctx.bench_dir))
    return rec


def reference_logits(ctx, pool, x):
    """(vt, vd) of the configuration's reference on frames ``x``
    (a device tensor); ``pool`` gives the calibration batch."""
    cfg, dev = ctx.cfg, ctx.device
    params, state = onet_weights.make(ctx.seed, cfg["in_channels"],
                                      cfg["base"], dev)
    if cfg["precision"] == "int8":
        from benchmark.reference import quant
        fp = quant.fold(params, state)
        calib = torch.as_tensor(pool[:cfg["calibration_frames"]]).to(dev)
        scales = quant.calibrate(fp, calib)
        return quant.quant_logits(fp, scales, x, qmax=cfg["qmax"])
    from benchmark.reference.onet import eval_logits
    return eval_logits(params, state, x)


def judge_sample(ctx, pool, sample) -> dict:
    from benchmark.reference.onet import label_gap

    idx = [k for k, _ in sample]
    labels = torch.as_tensor(np.stack([m for _, m in sample]))
    # the reference runs once a frame; a frame served twice is judged twice
    uniq, inv = np.unique(np.asarray(idx), return_inverse=True)
    x = torch.as_tensor(pool[uniq]).to(ctx.device)
    vt, vd = reference_logits(ctx, pool, x)
    inv = torch.as_tensor(inv.reshape(-1), device=vt.device)
    vt, vd = vt[inv], vd[inv]
    limits = ctx.cfg["limits"]["serve"]
    return {k: (v, limits.get(k))
            for k, v in label_gap(vt, vd, labels).items()}


def free_program(st) -> None:
    st.pop("sess", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(ctx, st, rec) -> dict:
    free_program(st)
    return judge_sample(ctx, st["pool"], st["sample"])
