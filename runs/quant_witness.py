"""The JAX package's int8 and bf16 graphs on a checkpoint and frames that
the PyTorch port's int8 gate left (``python -m
onet_tpu_torch.runs.quant_validate ... --witness DIR``), on the CPU: a
second reading of the int8 graph's mask agreement on the same model.

    JAX_PLATFORMS=cpu PYTHONPATH=. python runs/quant_witness.py DIR/NAME

``NAME.params.npz`` is the checkpoint in this package's format;
``NAME.frames.npz`` holds the calibration frames, the held-out frames, the
port's calibration maxima and its masks of the held-out frames under each
graph. This package calibrates and quantizes the checkpoint itself, as
``runs/quant_validate.py`` does (jitted; calibration in batches of BATCH,
whose per-channel maxima combine exactly), then runs its bf16, float32
and int8 graphs (channel-stacked) on the first FRAMES held-out frames:
XLA's int8 conv on the CPU takes about half a minute a 224^2 frame at
base 64 on 8 cores. One JSON line: each graph's agreement with the bf16
graph, this package's and the port's on the same frames; each graph's
agreement with the port's same graph; the largest relative difference of
the calibration maxima.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from onet_tpu.core.checkpoint import load_checkpoint
from onet_tpu.core.policy import BF16_COMPUTE, DEFAULT
from onet_tpu.models.infer import fold_onet, onet_infer
from onet_tpu.models.onet import onet_init
from onet_tpu.models.quant import calibrate, onet_infer_q, quantize_folded

FRAMES = 8
BATCH = 2
GRAPHS = ("f32", "int8_head_bf16=True", "int8_head_bf16=False")


def main():
    stem = sys.argv[1]
    z = np.load(stem + ".frames.npz")
    w1 = np.load(stem + ".params.npz")["p:top/inc/conv1/w"]
    params, bn = onet_init(jax.random.key(0), w1.shape[2], base=w1.shape[3])
    params, bn, epoch = load_checkpoint(stem + ".params.npz", params, bn)
    folded = jax.jit(fold_onet)(params, bn)

    t0 = time.perf_counter()
    calib = z["calib"]
    parts = [calibrate(folded, jnp.asarray(calib[i:i + BATCH]))
             for i in range(0, len(calib), BATCH)]
    scales = {k: np.max([p[k] for p in parts], axis=0) for k in parts[0]}
    max_rel = max(float(np.max(np.abs(scales[k] - z[f"max:{k}"])
                               / np.maximum(z[f"max:{k}"], 1e-30)))
                  for k in scales)
    q = quantize_folded(folded, scales)

    run = {
        "bf16": jax.jit(lambda x: onet_infer(
            folded, x, policy=BF16_COMPUTE, channel_stack=True,
            pair_pack=False)[1]),
        "f32": jax.jit(lambda x: onet_infer(
            folded, x, policy=DEFAULT, channel_stack=True,
            pair_pack=False)[1]),
        "int8_head_bf16=True": jax.jit(
            lambda x: onet_infer_q(q, x, head_bf16=True)[1]),
        "int8_head_bf16=False": jax.jit(
            lambda x: onet_infer_q(q, x, head_bf16=False)[1]),
    }
    held = z["held"][:FRAMES]
    masks = {k: np.concatenate([np.asarray(fn(jnp.asarray(
        held[i:i + BATCH]))) for i in range(0, len(held), BATCH)])
        for k, fn in run.items()}
    port = {k: z[f"mask:{k}"][:FRAMES].astype(masks[k].dtype)
            for k in masks}

    def agree(a, b):
        return float(np.mean(a == b))

    print(json.dumps({
        "checkpoint": os.path.basename(stem), "epoch": int(epoch),
        "frames": list(held.shape), "seconds": time.perf_counter() - t0,
        "jax_vs_jax_bf16": {k: agree(masks[k], masks["bf16"])
                            for k in GRAPHS},
        "port_vs_port_bf16": {k: agree(port[k], port["bf16"])
                              for k in GRAPHS},
        "port_vs_port_bf16_all_held_out": {
            k: agree(z[f"mask:{k}"], z["mask:bf16"]) for k in GRAPHS},
        "jax_vs_port": {k: agree(masks[k], port[k]) for k in masks},
        "calibration_max_rel_diff": max_rel}), flush=True)


if __name__ == "__main__":
    main()
