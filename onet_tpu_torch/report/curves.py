"""Training curves and result grids as PNGs (``onet_tpu/report/curves.py``:
``save_training_curves``, ``save_nau_rain_grid``,
``save_method_comparison_grid``, ``save_two_stage_grid``; the ZY-3 grids
come with that workload).

The reference's loss and metric curve figure and its NAU, method-comparison
and two-stage layouts; the grids take numpy arrays. matplotlib is imported
here, at module level: drivers import this module only when they log or
draw, so a host without matplotlib trains with ``log=False``.
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
