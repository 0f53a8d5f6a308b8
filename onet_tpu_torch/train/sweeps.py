"""Per-SNR training/evaluation sweeps and checkpoint-directory verification
(``onet_tpu/train/sweeps.py``).

Reference counterparts (Train_Onet_on_simclutter_20250407.py):
* ``train_by_snr``          — train_onet_by_snr (:456-479): train a fresh
  copy of the same init per PSNR level;
* ``test_by_snr``           — test_onet_by_snr / verify_onet_simclutter
  (:420-454,480-510): per-PSNR metric dict with an 'ave' row;
* ``verify_checkpoint_dir`` — test_model_performance (:512-524): glob a
  checkpoint directory, load each model, run the per-PSNR sweep.

Seeds stand where the JAX package takes keys: level ``lvl`` of
``per_snr_datasets(seed)`` draws from a generator seeded with
``derive_seed(seed, 1000 + lvl)``, the counterpart of JAX's
``fold_in(key, 1000 + lvl)`` (the numbers differ from JAX's). ``device``
(default: the card) is the one argument the JAX functions lack.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict

import torch

from onet_tpu_torch.core.bridge import TORCH_EXTS
from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.core.prng import derive_seed, make_generator
from onet_tpu_torch.data.simclutter import simclutter_datasets
from onet_tpu_torch.metrics.roc import dr_at_far, fg_score
from onet_tpu_torch.metrics.segmentation import align_labels_by_accuracy
from onet_tpu_torch.models.onet import onet_forward, predict_label
from onet_tpu_torch.train.simclutter import SimclutterConfig, train
from onet_tpu_torch.train.steps import make_eval_step
from onet_tpu_torch.train.two_stage import verify_single_stage


def per_snr_datasets(seed: int, levels=range(0, 11),
                     frames_per_level: int = 150, crop: int = 224,
                     device=None):
    """{psnr: full ArrayDataset} for sweep evaluation (no train split),
    generated on ``device``."""
    dev = resolve_device(device)
    out = {}
    for lvl in levels:
        tr, _ = simclutter_datasets(
            make_generator(derive_seed(seed, 1000 + lvl), dev),
            low_snr=lvl, high_snr=lvl, train_frac=1.0,
            frames_per_level=frames_per_level, crop=crop, device=dev)
        out[lvl] = tr
    return out


def test_by_snr(params, bn_state, datasets_by_psnr, *, batch_sz: int = 10,
                policy: Policy = DEFAULT, forward=None) -> Dict:
    """Per-PSNR metric dict with an 'ave' row, flip-aligned."""
    eval_step = make_eval_step(policy=policy, align="flip", forward=forward)
    return verify_single_stage(eval_step, params, bn_state,
                               datasets_by_psnr, batch_sz)


def threshold_sweep_by_snr(params, bn_state, datasets_by_psnr, *,
                           far_budgets=(1e-3, 1e-2, 5e-2, 1e-1),
                           policy: Policy = DEFAULT, forward=None) -> Dict:
    """Per-PSNR detection rates at explicit FAR budgets through the
    projection-threshold detector (``metrics/roc.py``; the reference's
    argmax is its threshold-0 point). Each level is forwarded in one call,
    as in the JAX package, under ``no_grad``. Returns {psnr: {"argmax":
    {"dr", "far"}, "thresh": {budget: {"far", "dr"}}}}."""
    fwd = forward or onet_forward
    report = {}
    for psnr, ds in datasets_by_psnr.items():
        x, labels = ds["imgs"], ds["labels"]
        with torch.no_grad(), policy.precision():
            out, _ = fwd(params, bn_state, x, train=False, policy=policy)
            vt, vd, raw = out.Vt, out.Vd, predict_label(out.S)
            del out
            aligned = align_labels_by_accuracy(raw, labels)
            fg_is_down = bool(torch.mean((raw == aligned).float()) > 0.5)
            score = fg_score(vt, vd, fg_is_down=fg_is_down)
            y = labels > 0
            hit = aligned > 0
            argmax = torch.stack([
                (hit & y).sum() / torch.clamp_min(y.sum(), 1),
                (hit & ~y).sum() / torch.clamp_min((~y).sum(), 1)]).tolist()
            rep = dr_at_far(score, labels, far_budgets)
        report[psnr] = {
            "argmax": {"dr": argmax[0], "far": argmax[1]},
            "thresh": {float(k): {"far": v[0], "dr": v[1]}
                       for k, v in rep.items()},
        }
    return report


def train_by_snr(base_config: SimclutterConfig, *, levels=range(0, 11),
                 policy: Policy = DEFAULT, device=None) -> Dict:
    """Train an identically-initialized model per PSNR level; returns
    {psnr: (params, bn_state, history)}. The config's seed re-initializes
    each level (the reference reloads init_param_dict, :464,474); each
    level writes under out_root/onet_snr_{lvl:02d}."""
    results = {}
    for lvl in levels:
        cfg = dataclasses.replace(
            base_config, low_snr=lvl, high_snr=lvl,
            out_root=os.path.join(base_config.out_root,
                                  f"onet_snr_{lvl:02d}"))
        results[lvl] = train(cfg, policy=policy, log=False, device=device)
    return results


def verify_checkpoint_dir(model_root: str, *, datasets_by_psnr=None,
                          batch_sz: int = 10, policy: Policy = DEFAULT,
                          device=None) -> Dict:
    """Evaluate every checkpoint (.npz and reference .pt/.pth/.pytorch) in
    a directory across the PSNR levels. Each file rebuilds its own model
    (``core/checkpoint.load_arch_auto``: the family from its meta, the
    vanilla width from its shapes), so a directory of mixed families
    verifies in one call."""
    from onet_tpu_torch.core.checkpoint import load_arch_auto

    files = sorted(p for ext in (".npz",) + tuple(TORCH_EXTS)
                   for p in glob.glob(os.path.join(model_root, "*" + ext)))
    if datasets_by_psnr is None:
        datasets_by_psnr = per_snr_datasets(7, device=device)
    report = {}
    for f in files:
        arch, params, bn_state, epoch = load_arch_auto(f, device)
        report[os.path.basename(f)] = {
            "epoch": epoch,
            "arch": arch.name,
            "per_snr": test_by_snr(
                params, bn_state, datasets_by_psnr, batch_sz=batch_sz,
                policy=policy,
                forward=None if arch.vanilla else arch.forward),
        }
    return report
