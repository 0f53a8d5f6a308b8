"""Workload 3: zero-shot transfer to NAU marine-radar rain clutter
(``onet_tpu/train/nau.py``).

Reference: exp_nau_rain_20240513.py:40-76 (test_naurain_onet): run the
simclutter-trained model on radar frames and report (acc, miou, dr, far,
tiou) with the flip-test alignment, the input PSNR/SNR, and
measure_snr_on_fg (Train_Onet_on_simclutter_20250407.py:46-95): the SNR of
the foreground branch's projection map, normalized per frame, over the
input's.

``forward`` swaps in another backbone family's forward
(``models/arch.py``); the default is the vanilla conv U-Net.
"""

from __future__ import annotations

from typing import Dict

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.data.arrays import ArrayDataset, batch_iterator
from onet_tpu_torch.metrics.segmentation import (
    align_labels_by_accuracy, evaluate_binary_segmentation, psnr_snr)
from onet_tpu_torch.models.onet import onet_forward, predict_label
from onet_tpu_torch.ops.normalize import minmax_per_frame
from onet_tpu_torch.train.two_stage import KEYS, to_host

SNR_KEYS = ("input_psnr", "input_snr", "fg_psnr", "fg_snr")


def make_transfer_eval(*, policy: Policy = DEFAULT, forward=None):
    """(params, bn_state, x, labels) -> (metrics, (in_psnr, in_snr,
    fg_psnr, fg_snr), pred, (vt, vd)), under ``no_grad`` and the policy's
    precision; the foreground map is chosen on the device."""
    fwd = forward or onet_forward

    def eval_batch(params, bn_state, x, labels):
        with torch.no_grad(), policy.precision():
            out, _ = fwd(params, bn_state, x, train=False, policy=policy)
            raw = predict_label(out.S)
            pred = align_labels_by_accuracy(raw, labels)
            metrics = evaluate_binary_segmentation(pred, labels)
            in_psnr, in_snr = psnr_snr(x[..., 0], labels)

            # segmented-foreground SNR (measure_snr_on_fg): the projection
            # map of whichever branch carries the foreground
            flipped = torch.any(raw != pred)
            vt = minmax_per_frame(out.Vt[..., None])[..., 0]
            vd = minmax_per_frame(out.Vd[..., None])[..., 0]
            fg = torch.where(flipped, vt, vd)
            fg_psnr, fg_snr = psnr_snr(fg, labels)
            return (metrics, (in_psnr, in_snr, fg_psnr, fg_snr), pred,
                    (vt, vd))

    return eval_batch


def test_naurain(params, bn_state, test_ds: ArrayDataset, *,
                 batch_sz: int = 5, policy: Policy = DEFAULT,
                 ids=None, fig_path: str = None, forward=None) -> Dict:
    """Transfer eval, batch-averaged; with ``fig_path`` also the
    show_nau_rain grid (echo/gt/pred/Vt/Vd rows, columns titled by frame
    name, utils_20231218.py:595-620) of the first batch."""
    eval_batch = make_transfer_eval(policy=policy, forward=forward)
    rows, first = [], None
    for batch in batch_iterator(test_ds, batch_sz):
        metrics, snr4, pred, vtvd = eval_batch(params, bn_state,
                                               batch["imgs"],
                                               batch["labels"])
        if first is None:
            first = (batch, pred, vtvd)
        rows.append(torch.stack([metrics[k] for k in KEYS] + list(snr4)))
    rows = torch.stack(rows).tolist()         # one host read
    # the batch means, summed in batch order as the JAX package sums them
    out = {k: sum(col) / len(rows)
           for k, col in zip(KEYS + SNR_KEYS, zip(*rows))}
    if fig_path and first is not None:
        from onet_tpu_torch.report.curves import save_nau_rain_grid

        batch, pred, (vt, vd) = first
        save_nau_rain_grid(
            fig_path, to_host(batch["imgs"]),
            list(ids or [])[:batch["imgs"].shape[0]],
            to_host(vt), to_host(vd), to_host(batch["labels"]),
            to_host(pred), title="nau_rain_transfer")
    return out
