"""Training curves and result grids as PNGs (``onet_tpu/report/curves.py``).

The reference's loss and metric curve figures and its figure suite
(utils_20231218.py:479-659): show_segmentation (save_segmentation_grid),
show_unet_adversarial (save_adversarial_grid), show_unet_adversarial_v2
(save_result_grid), show_onet_img (save_tensor_matrix), show_nau_rain
(save_nau_rain_grid), show_unet_2ndstage_test (save_two_stage_grid),
show_nau_train_result (save_loss_acc_curves), the method-comparison
layout, and draw_test_res's epoch- and metric-named 5x5 ZY-3 grids
(uti_zy3_test_20240123.py:42-97, save_test_res_grids). The grids take
numpy arrays. matplotlib is imported here, at module level: the drivers
and the command line import this module only where ``report.can_draw()``
finds matplotlib, so a host without it trains, evaluates and reports
without the figures.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def save_training_curves(path: str, loss: List[float],
                         eval_history: Dict[int, Dict[str, float]]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, axs = plt.subplots(1, 2, figsize=(10, 4))
    axs[0].plot(loss, "r", label="train_loss")
    axs[0].legend()
    axs[0].set_xlabel("epoch")
    if eval_history:
        epochs = sorted(eval_history)
        styles = {"acc": "r", "miou": "g-.", "dr": "b--", "far": "k:",
                  "tiou": "m"}
        for key, style in styles.items():
            vals = [eval_history[e].get(key) for e in epochs]
            if all(v is not None for v in vals):
                axs[1].plot(epochs, vals, style, label=key)
        axs[1].legend()
        axs[1].set_xlabel("epoch")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def _imshow(ax, img):
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    ax.imshow(img, cmap=None if img.ndim == 3 else "viridis")
    ax.set_xticks([])
    ax.set_yticks([])


def save_nau_rain_grid(path: str, x: np.ndarray, names: List[str],
                       pred_t: np.ndarray, pred_d: np.ndarray,
                       label: np.ndarray, pred: np.ndarray,
                       title: str = ""):
    """NAU radar layout: echo / gt / pred / Vt / Vd rows with the frame
    name atop each column (show_nau_rain, utils_20231218.py:595-620)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = min(5, np.asarray(x).shape[0])
    rows = [x, label, pred, pred_t, pred_d]
    fig, axs = plt.subplots(5, n, figsize=(8, 8), squeeze=False,
                            gridspec_kw={"wspace": 0, "hspace": 0})
    for r, arr in enumerate(rows):
        arr = np.asarray(arr)
        for c in range(n):
            _imshow(axs[r][c], arr[c])
            if r == 0 and c < len(names):
                axs[r][c].set_title(str(names[c]).replace("_", "\n", 1),
                                    fontsize=8)
    if title:
        fig.suptitle(title)
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def save_method_comparison_grid(path: str, x: np.ndarray, label: np.ndarray,
                                methods, fars=None, max_rows: int = 5):
    """Method-comparison layout: one row per frame, columns =
    input / ground truth / one per method, the method's measured P_fa in
    the column title (the reference's CFAR/InfoSeg/Onet revision figures,
    exp_nau_rain_20240513.py:177-261,430-533).

    ``methods`` is an ordered {name: predictions [N, H, W]} dict;
    ``fars`` optionally maps the same names to a mean false-alarm rate.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = min(max_rows, np.asarray(x).shape[0])
    cols = ["Input frame", "Ground truth"] + list(methods)
    fig, axs = plt.subplots(n, len(cols),
                            figsize=(2.2 * len(cols), 2.2 * n),
                            squeeze=False,
                            gridspec_kw={"wspace": 0.01, "hspace": 0.01})
    arrays = [np.asarray(x), np.asarray(label)] + [
        np.asarray(v) for v in methods.values()]
    for c, (name, arr) in enumerate(zip(cols, arrays)):
        title = name
        if fars and name in fars:
            title = f"{name} $P_{{fa}}$={fars[name]:.4f}"
        axs[0][c].set_title(title, fontsize=9)
        for r in range(n):
            _imshow(axs[r][c], arr[r])
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return path


def save_two_stage_grid(path: str, x1: np.ndarray, x2: np.ndarray,
                        fg: np.ndarray, label: np.ndarray,
                        label1: np.ndarray, label2: np.ndarray,
                        title: str = ""):
    """Two-stage composition layout: input / stage-2 input / foreground /
    gt / stage-1 pred / stage-2 pred (show_unet_2ndstage_test,
    utils_20231218.py:622-641)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = min(5, np.asarray(x1).shape[0])
    rows = [x1, x2, fg, label, label1, label2]
    fig, axs = plt.subplots(6, n, figsize=(8 * 5 / 6, 8), squeeze=False,
                            gridspec_kw={"wspace": 0, "hspace": 0})
    for r, arr in enumerate(rows):
        arr = np.asarray(arr)
        for c in range(n):
            _imshow(axs[r][c], arr[c])
    fig.suptitle(f"{title}_x1_x2_fg_label_gt12")
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def save_result_grid(path: str, x: np.ndarray, pred_t: np.ndarray,
                     pred_d: np.ndarray, label: np.ndarray,
                     pred: np.ndarray, title: str = "", max_cols: int = 5):
    """5-row grid: input / Vt / Vd / GT / prediction (the reference's
    show_unet_adversarial_v2 layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = min(max_cols, x.shape[0])
    rows = [("input", x), ("pred_t", pred_t), ("pred_d", pred_d),
            ("label", label), ("pred", pred)]
    fig, axs = plt.subplots(len(rows), n, figsize=(2 * n, 2 * len(rows)),
                            squeeze=False)
    for r, (name, arr) in enumerate(rows):
        for c in range(n):
            img = np.asarray(arr[c])
            if img.ndim == 3 and img.shape[-1] == 1:
                img = img[..., 0]
            axs[r][c].imshow(img, cmap=None if img.ndim == 3 else "viridis")
            axs[r][c].set_xticks([])
            axs[r][c].set_yticks([])
        axs[r][0].set_ylabel(name)
    if title:
        fig.suptitle(title, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def save_segmentation_grid(path: str, x: np.ndarray, pred: np.ndarray,
                           label: np.ndarray, title: str = ""):
    """src/gt/pred column grid — the v1 show_segmentation layout
    (utils_20231218.py:479-533): one row per input channel (rgb images
    collapse to a single color row), then ground truth, then prediction;
    up to 5 columns, no tick labels."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x = np.asarray(x)
    n = min(5, x.shape[0])
    rgb = x.ndim == 4 and x.shape[-1] == 3
    chn_rows = 1 if (rgb or x.ndim == 3) else x.shape[-1]
    rows = chn_rows + 2
    fig, axs = plt.subplots(rows, n, figsize=(2 * n, 2 * rows),
                            squeeze=False,
                            gridspec_kw={"wspace": 0, "hspace": 0})
    for c in range(n):
        if rgb or x.ndim == 3:
            _imshow(axs[0][c], x[c])
        else:
            for ch in range(chn_rows):
                _imshow(axs[ch][c], x[c][..., ch])
        _imshow(axs[chn_rows][c], np.asarray(label)[c])
        _imshow(axs[chn_rows + 1][c], np.asarray(pred)[c])
    fig.suptitle(f"src_gt_pred_{title}" if title else "src_gt_pred")
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def save_adversarial_grid(path: str, x: np.ndarray, pred_t: np.ndarray,
                          pred_d: np.ndarray, label: np.ndarray,
                          title: str = ""):
    """4-row grid: input / GT / top prediction / down prediction — the v1
    show_unet_adversarial layout (utils_20231218.py:534-552; the v2
    5-row variant with the fused argmax is save_result_grid)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = min(4, np.asarray(x).shape[0])
    rows = [x, label, pred_t, pred_d]
    fig, axs = plt.subplots(4, n, figsize=(8, 8), squeeze=False,
                            gridspec_kw={"wspace": 0, "hspace": 0})
    for r, arr in enumerate(rows):
        arr = np.asarray(arr)
        for c in range(n):
            _imshow(axs[r][c], arr[c])
    fig.suptitle(f"src_gt_predTop_predDown_{title}" if title
                 else "src_gt_predTop_predDown")
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def save_tensor_matrix(path: str, tensors: List[np.ndarray],
                       title: str = ""):
    """N x N matrix: row r shows ``tensors[r]`` across the first N batch
    elements (show_onet_img, utils_20231218.py:536-572). N = min(batch,
    len(tensors))."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = min(np.asarray(tensors[0]).shape[0], len(tensors))
    fig, axs = plt.subplots(n, n, figsize=(8, 8), squeeze=False,
                            gridspec_kw={"wspace": 0, "hspace": 0})
    for r in range(n):
        arr = np.asarray(tensors[r])
        for c in range(n):
            _imshow(axs[r][c], arr[c])
    if title:
        fig.suptitle(title)
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)
    return path


def save_loss_acc_curves(path: str, loss: List[float], acc: List[float],
                         miou: List[float]):
    """Two stacked panels: train loss, then acc+miou vs epochs
    (show_nau_train_result, utils_20231218.py:643-659)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, axs = plt.subplots(2, 1, sharex=True)
    axs[0].plot(loss, "b", label="train_loss")
    axs[0].set_title("train_loss vs epochs")
    axs[1].plot(acc, "r-", label="pixel_acc")
    axs[1].plot(miou, "g", label="miou_list")
    axs[1].set_xlabel("epochs")
    axs[1].legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_test_res_grids(out_root: str, model_name: str, rows: List[dict],
                        test_loss: float, acc: float, miou: float,
                        epoch: int = None, draw_all: bool = False,
                        seed: int = 0) -> List[str]:
    """draw_test_res parity (uti_zy3_test_20240123.py:42-97): 5x5 grids,
    column = one test image with rows rgb/label/pred/vt/vd, the first row
    titled with img_id + per-image metrics; files named with the epoch and
    mean metrics. ``rows`` entries: img_id, rgb, label, pred, vt, vd, acc,
    miou (and optionally dr/far)."""
    os.makedirs(out_root, exist_ok=True)
    idx = np.arange(len(rows))
    if not draw_all:
        np.random.default_rng(seed).shuffle(idx)
        idx = idx[:5]
        rounds = 1
    else:
        rounds = max(len(rows) // 5, 1)
    keys = ["rgb", "label", "pred", "vt", "vd"]
    has_dr = "dr" in rows[0]
    paths = []
    for rnd in range(rounds):
        fig, axs = plt.subplots(5, 5, figsize=(10, 10), squeeze=False,
                                gridspec_kw={"wspace": 0, "hspace": 0})
        for i in range(5):
            r = rows[idx[(rnd * 5 + i) % len(idx)]]
            sub = "%s\nacc:%.4f\nmiou:%.4f" % (r["img_id"], r["acc"],
                                               r["miou"])
            if has_dr:
                sub += "\ndr:%.4f\nfar:%.4f" % (r["dr"], r["far"])
            axs[0][i].set_title(sub, fontsize=8)
            for j, k in enumerate(keys):
                disp = np.array(np.asarray(r[k], np.float32), copy=True)
                if disp.ndim == 3 and disp.shape[-1] == 1:
                    disp = disp[..., 0]
                if np.all(disp == disp.flat[0]):   # constant map: fix range
                    disp[0, 0], disp[0, 1] = 1, 0
                axs[j][i].imshow(disp)
                axs[j][i].axis("off")
        fig.suptitle("zy3_rgb_gt_pred_vt_vd")
        parts = [model_name]
        if epoch is not None:
            parts.append("epoch_%03d" % epoch)
        parts.append("round_%d" % rnd)
        if has_dr:
            mean_dr = float(np.mean([r["dr"] for r in rows]))
            mean_far = float(np.mean([r["far"] for r in rows]))
            parts.append("acc_%.4f_miou_%.4f_dr_%.4f_far_%.2E"
                         % (acc, miou, mean_dr, mean_far))
        else:
            parts.append("loss_%.2E_acc_%.4f_miou_%.4f"
                         % (test_loss, acc, miou))
        p = os.path.join(out_root, "_".join(parts) + ".png")
        fig.savefig(p)
        plt.close(fig)
        paths.append(p)
    return paths
