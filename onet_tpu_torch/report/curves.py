"""Training-curve PNGs (``onet_tpu/report/curves.py::save_training_curves``;
the rest of that module is not ported yet).

The reference's loss and metric curve figure. matplotlib is imported here,
at module level: drivers import this module only when they log, so a host
without matplotlib trains with ``log=False``.
"""

from __future__ import annotations

import os
from typing import Dict, List

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
