"""The int8 serving gate on trained checkpoints, on the card: mask
agreement of the int8 graph with the bf16 folded graph on held-out frames,
beside the bf16 graph's own agreement with the float32 graph, which says
how close the model's masks sit to the softmax's edge.

It follows the JAX package's ``runs/quant_validate.py`` (calibration on 16
frames of the train split, agreement over the test split, both head forms)
with the frames at the port's checkpoints' training distribution: the
simclutter datasets at the driver's levels and sizes (levels 0-2, 150
frames a level, 224^2), drawn anew from SEED. The JAX script's checkpoint
was trained at levels 5-10, so it draws those.

    python -m onet_tpu_torch.runs.quant_validate CKPT.npz [...]
    python -m onet_tpu_torch.runs.quant_validate --train-epochs 4,10,20
    python -m onet_tpu_torch.runs.quant_validate --train-epochs 4 \\
        --witness DIR

With checkpoints, each is validated. With ``--train-epochs``, the
simclutter driver (its defaults: 224^2, batch 10, base 64, Adam at 5e-6;
bf16, the pair-packed kernels) trains one run to the last epoch listed,
keeping a checkpoint at each, and each is validated. One JSON line a
checkpoint, with the card's name and power limit. ``chip_smoke.py``
phase 10 gates on the same frames and the same functions.

With ``--witness DIR``, each checkpoint also leaves in DIR what the JAX
package needs to read the same model on the same frames
(``runs/quant_witness.py``): ``<name>.params.npz``, its parameters and BN
state in the JAX checkpoint format, and ``<name>.frames.npz``, the
calibration and held-out frames, the port's calibration maxima and its
masks of the held-out frames under each graph.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

LEVELS = (0, 2)         # the simclutter driver's low_snr, high_snr
SEED = 1981 + 190
CALIB = 16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def held_out(device=None):
    """(calibration frames, held-out frames) at the training distribution:
    the first CALIB frames of the train split, and the test split."""
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.data.simclutter import simclutter_datasets

    dev = resolve_device(device)
    train_ds, test_ds = simclutter_datasets(
        torch.Generator(dev).manual_seed(SEED), low_snr=LEVELS[0],
        high_snr=LEVELS[1], device=dev)
    return train_ds["imgs"][:CALIB].clone(), test_ds["imgs"].clone()


def quantized(params, state, calib) -> tuple:
    """(folded, calibration maxima, q) of a checkpoint's trees."""
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.models.quant import calibrate, quantize_folded

    with torch.inference_mode():
        folded = fold_onet(params, state)
        scales = calibrate(folded, calib)
        return folded, scales, quantize_folded(folded, scales)


def graph_masks(q, folded, x) -> dict:
    """The masks of ``x`` under the bf16 folded graph, the float32 graph and
    the int8 graph with either head form."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models.infer import onet_infer
    from onet_tpu_torch.models.quant import onet_infer_q

    with torch.inference_mode():
        out = {"bf16": onet_infer(folded, x, policy=BF16_COMPUTE,
                                  pair_pack=False)[1]}
        with DEFAULT.precision():
            out["f32"] = onet_infer(folded, x, policy=DEFAULT,
                                    pair_pack=False)[1]
        for hb in (True, False):
            out[f"int8_head_bf16={hb}"] = onet_infer_q(q, x,
                                                       head_bf16=hb)[1]
    return out


def agreement(masks: dict) -> dict:
    """Each graph's mask agreement with the bf16 folded graph's, and the
    bf16 graph's foreground share."""
    bf = masks["bf16"]
    out = {k: float((m == bf).float().mean()) for k, m in masks.items()
           if k != "bf16"}
    out["foreground_share_bf16"] = float(bf.float().mean())
    return out


def train_milestones(epochs, out_root: str) -> list:
    """The simclutter driver at its defaults, bf16, pair-packed, to
    max(epochs), a checkpoint at each listed epoch (1-based counts)."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train.simclutter import SimclutterConfig, train

    old, O.PAIR_PACK = O.PAIR_PACK, True
    try:
        train(SimclutterConfig(epoch_nums=max(epochs), out_root=out_root,
                               save_epochs=tuple(e - 1 for e in epochs),
                               eval_every=10 ** 6),
              policy=BF16_COMPUTE, log=False)
    finally:
        O.PAIR_PACK = old
    return sorted(glob.glob(os.path.join(out_root, "*_epoch_*.npz")),
                  key=lambda p: int(p.split("_epoch_")[1].split("_")[0]))


def save_witness(out_dir: str, path: str, calib, held, scales,
                 masks: dict) -> None:
    """The JAX package's inputs for one checkpoint (module docstring)."""
    name = os.path.splitext(os.path.basename(path))[0]
    with np.load(path) as z:
        np.savez(os.path.join(out_dir, name + ".params.npz"),
                 **{k: z[k] for k in z.files
                    if k == "__epoch__" or k[:2] in ("p:", "s:")})
    np.savez_compressed(
        os.path.join(out_dir, name + ".frames.npz"),
        calib=calib.cpu().numpy(), held=held.cpu().numpy(),
        **{f"max:{k}": v.cpu().numpy() for k, v in scales.items()},
        **{f"mask:{k}": m.cpu().numpy().astype(np.uint8)
           for k, m in masks.items()})


def main(argv=None) -> None:
    from onet_tpu_torch.core.bridge import load_onet_npz

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoints", nargs="*")
    ap.add_argument("--train-epochs", default="")
    ap.add_argument("--witness", default="")
    args = ap.parse_args(argv)
    calib, held = held_out()
    card = card_line()
    paths = list(args.checkpoints)
    tmp = None
    if args.train_epochs:
        tmp = tempfile.mkdtemp(prefix="onet_quant_validate_")
        paths += train_milestones(
            [int(e) for e in args.train_epochs.split(",")], tmp)
    if args.witness:
        os.makedirs(args.witness, exist_ok=True)
    for path in paths:
        params, state, epoch = load_onet_npz(path)
        folded, scales, q = quantized(params, state, calib)
        masks = graph_masks(q, folded, held)
        rec = {"checkpoint": os.path.basename(path), "epoch": epoch,
               "held_out": list(held.shape), "card": card,
               **agreement(masks)}
        print(json.dumps(rec), flush=True)
        if args.witness:
            save_witness(args.witness, path, calib, held, scales, masks)
    if tmp:
        for p in glob.glob(os.path.join(tmp, "*")):
            os.remove(p)
        os.rmdir(tmp)


if __name__ == "__main__":
    main()
