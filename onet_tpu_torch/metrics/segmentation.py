"""Segmentation metrics on the device (``onet_tpu/metrics/segmentation.py``).

The reference's metric bundle: accuracy, two-class mIoU with its empty-class
conventions (both empty -> 1, one empty -> 0), target IoU, detection and
false-alarm rates with the np.spacing(1) epsilon; label alignment by the
accuracy flip test or by K=2 Hungarian matching (keep or swap, identity on
ties); peak/region SNR; intensity-ranked reorderings. Every function takes
{0,1} label maps of matching shape and reduces over all elements, as the
reference flattens batches first.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = float(np.spacing(1.0))


def _counts(pred: torch.Tensor, target: torch.Tensor):
    p = pred.bool()
    t = target.bool()
    return ((p & t).sum(), (p & ~t).sum(), (~p & t).sum(), (~p & ~t).sum())


def accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred == target).float().mean()


def _class_iou(inter, union, gt_n, pd_n, floor):
    both_empty = (gt_n == 0) & (pd_n == 0)
    one_empty = (gt_n == 0) ^ (pd_n == 0)
    iou = inter.float() / torch.clamp_min(union.float(), floor)
    return torch.where(both_empty, torch.ones_like(iou),
                       torch.where(one_empty, torch.zeros_like(iou), iou))


def miou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """2-class mean IoU with the reference's empty-class conventions."""
    tp, fp, fn, tn = _counts(pred, target)
    return (_class_iou(tp, tp + fp + fn, tp + fn, tp + fp, 1.0)
            + _class_iou(tn, tn + fn + fp, tn + fp, tn + fn, 1.0)) / 2.0


def target_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    tp, fp, fn, _ = _counts(pred, target)
    return tp.float() / ((tp + fp + fn).float() + EPS)


def detection_rate(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    tp, _, fn, _ = _counts(pred, target)
    return tp.float() / ((tp + fn).float() + EPS)


def false_alarm_rate(pred: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    _, fp, _, tn = _counts(pred, target)
    return fp.float() / ((fp + tn).float() + EPS)


def evaluate_binary_segmentation(pred: torch.Tensor, target: torch.Tensor):
    """The (acc, miou, dr, far, tiou) bundle from one set of counts."""
    tp, fp, fn, tn = (t.float() for t in _counts(pred, target))
    n = tp + fp + fn + tn
    m = (_class_iou(tp, tp + fp + fn, tp + fn, tp + fp, EPS)
         + _class_iou(tn, tn + fn + fp, tn + fp, tn + fn, EPS)) / 2.0
    return {"acc": (tp + tn) / n, "miou": m, "dr": tp / (tp + fn + EPS),
            "far": fp / (fp + tn + EPS), "tiou": tp / (tp + fp + fn + EPS)}


def align_labels_by_accuracy(pred: torch.Tensor,
                             target: torch.Tensor) -> torch.Tensor:
    """Flip iff the flipped prediction is strictly more accurate."""
    flip = accuracy(pred, target) < accuracy(1 - pred, target)
    return torch.where(flip, 1 - pred, pred)


def align_labels_hungarian(pred: torch.Tensor,
                           target: torch.Tensor) -> torch.Tensor:
    """Hungarian matching for K=2: swap iff the swap agrees on strictly
    more pixels (identity kept on ties)."""
    swap = ((1 - pred) == target).sum() > (pred == target).sum()
    return torch.where(swap, 1 - pred, pred)


def psnr_snr(img: torch.Tensor, label: torch.Tensor):
    """Peak and region SNR of the labelled foreground against the
    background energy."""
    lab = label.to(img.dtype)
    tgt = img * lab
    n_t = lab.sum()
    erc = (img - tgt).square().sum() / (img.numel() - n_t + EPS)
    psnr = 10.0 * torch.log10(tgt.max().square() / erc)
    snr = 10.0 * torch.log10(tgt.square().sum() / (n_t + EPS) / erc)
    return psnr, snr


def _region_sums(pred, echos, num_k):
    return torch.stack([torch.where(pred == c, echos, 0.0).sum()
                        for c in range(num_k)])


def reorder_by_intensity(pred: torch.Tensor, echos: torch.Tensor,
                         num_k: int = 2) -> torch.Tensor:
    """Rank the predicted regions by summed echo intensity: least intense
    -> 0, most -> 1, and for num_k == 3 the middle one -> 2."""
    if num_k not in (2, 3):
        raise ValueError(num_k)
    order = torch.argsort(_region_sums(pred, echos, num_k))
    out = torch.zeros_like(pred)
    out = torch.where(pred == order[num_k - 1], 1, out)
    if num_k == 3:
        out = torch.where(pred == order[1], 2, out)
    return out


def reorder_by_mean_intensity(pred: torch.Tensor,
                              echos: torch.Tensor) -> torch.Tensor:
    """Swap the labels if predicted background is brighter on average than
    predicted foreground."""
    n0 = torch.clamp_min((pred == 0).sum(), 1)
    n1 = torch.clamp_min((pred == 1).sum(), 1)
    m0 = torch.where(pred == 0, echos, 0.0).sum() / n0
    m1 = torch.where(pred == 1, echos, 0.0).sum() / n1
    return torch.where(m0 > m1, 1 - pred, pred)


def evaluate_with_intensity_reorder(pred: torch.Tensor, target: torch.Tensor,
                                    echos: torch.Tensor, num_k: int = 3):
    """Legacy 3-class radar eval: rank regions by intensity, merge the
    middle 'object' region into sea clutter, score (acc, miou)."""
    order = torch.argsort(_region_sums(pred, echos, num_k))
    out = torch.zeros_like(pred)
    out = torch.where(pred == order[num_k - 1], 1, out)
    if num_k == 3:
        out = torch.where(pred == order[1], 1, out)
    return accuracy(out, target), miou(out, target)
