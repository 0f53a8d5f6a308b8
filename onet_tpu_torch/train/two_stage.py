"""Two-stage Onet composition and per-PSNR verification sweeps
(``onet_tpu/train/two_stage.py``).

Reference: test_2nd_stage_simclutter / verify_2nd_stage_onet
(Train_Onet_on_simclutter_20250407.py:296-418) and the single-stage sweep
verify_onet_simclutter (:420-454).

Stage 1 segments the raw frame; its foreground projection map (Vd if the
argmax labels were already GT-aligned, else Vt, :327-330) is per-frame
min-max normalized and fed to the stage-2 Onet (:332-333), trained on the
high-SNR regime. Metrics are the (acc, miou, dr, far, tiou) bundle per
stage with the flip-test alignment.

The reference branches on a host bool per batch; here, as in the JAX
package's one jitted graph, the predicate stays a 0-d tensor on the device
and selects the map with ``torch.where``: no host sync inside a batch. The
sweeps read each level's metrics to the host once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.data.arrays import batch_iterator
from onet_tpu_torch.metrics.segmentation import (
    align_labels_by_accuracy, evaluate_binary_segmentation)
from onet_tpu_torch.models.onet import onet_forward, predict_label
from onet_tpu_torch.ops.normalize import minmax_per_frame

KEYS = ("acc", "miou", "dr", "far", "tiou")


def make_two_stage_eval(*, policy: Policy = DEFAULT):
    """(params1, bn1, params2, bn2, x, labels) -> (m1, m2, pred1, pred2,
    (x2, fg_map)), under ``no_grad`` and the policy's precision."""

    def eval_batch(params1, bn1, params2, bn2, x, labels):
        with torch.no_grad(), policy.precision():
            out1, _ = onet_forward(params1, bn1, x, train=False,
                                   policy=policy)
            raw1 = predict_label(out1.S)
            pred1 = align_labels_by_accuracy(raw1, labels)
            m1 = evaluate_binary_segmentation(pred1, labels)

            flipped = torch.any(raw1 != pred1)
            # unchanged -> Vd carries the foreground; flipped -> Vt
            fg_map = torch.where(flipped, out1.Vt, out1.Vd)
            x2 = minmax_per_frame(fg_map[..., None])
            out2, _ = onet_forward(params2, bn2, x2, train=False,
                                   policy=policy)
            raw2 = predict_label(out2.S)
            pred2 = align_labels_by_accuracy(raw2, labels)
            m2 = evaluate_binary_segmentation(pred2, labels)
            return m1, m2, pred1, pred2, (x2, fg_map)

    return eval_batch


def to_host(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy, for the figures."""
    return t.detach().to("cpu", torch.float32).numpy()


def draw_two_stage(fig_path: str, eval_batch, params1, bn1, params2, bn2,
                   batch, title: str = "two_stage"):
    """show_unet_2ndstage_test layout (utils_20231218.py:622-641): input /
    stage-2 input / fg map / gt / stage-1 pred / stage-2 pred."""
    from onet_tpu_torch.report.curves import save_two_stage_grid

    m1, m2, pred1, pred2, (x2, fg) = eval_batch(
        params1, bn1, params2, bn2, batch["imgs"], batch["labels"])
    return save_two_stage_grid(
        fig_path, to_host(batch["imgs"]), to_host(x2),
        to_host(fg[..., None]), to_host(batch["labels"]), to_host(pred1),
        to_host(pred2), title=title)


def _level_means(per_batch) -> Dict[str, float]:
    """Batch-averaged metrics from a list of metric dicts of 0-d tensors:
    one host read, then the JAX package's float sums in batch order."""
    rows = torch.stack([torch.stack([m[k] for k in KEYS])
                        for m in per_batch]).tolist()
    return {k: sum(col) / len(rows) for k, col in zip(KEYS, zip(*rows))}


def verify_two_stage(params1, bn1, params2, bn2, datasets_by_psnr,
                     batch_sz: int = 10, *, policy: Policy = DEFAULT) -> Dict:
    """Per-PSNR (stage1, stage2) metric dict + 'ave' row, mirroring
    verify_2nd_stage_onet's report shape."""
    eval_batch = make_two_stage_eval(policy=policy)
    report = {}
    for psnr, ds in datasets_by_psnr.items():
        got1, got2 = [], []
        for batch in batch_iterator(ds, batch_sz):
            m1, m2, _, _, _ = eval_batch(params1, bn1, params2, bn2,
                                         batch["imgs"], batch["labels"])
            got1.append(m1)
            got2.append(m2)
        report[psnr] = {"stage1": _level_means(got1),
                        "stage2": _level_means(got2)}
    report["ave"] = {
        stage: {k: float(np.mean([report[p][stage][k]
                                  for p in report if p != "ave"]))
                for k in KEYS}
        for stage in ("stage1", "stage2")
    }
    return report


def verify_single_stage(eval_step, params, bn_state, datasets_by_psnr,
                        batch_sz: int = 10) -> Dict:
    """Per-PSNR sweep for one model (verify_onet_simclutter, :420-454)."""
    report = {}
    for psnr, ds in datasets_by_psnr.items():
        got = [eval_step(params, bn_state, batch["imgs"], batch["labels"])[0]
               for batch in batch_iterator(ds, batch_sz)]
        report[psnr] = _level_means(got)
    report["ave"] = {k: float(np.mean([report[p][k] for p in report
                                       if p != "ave"])) for k in KEYS}
    return report
