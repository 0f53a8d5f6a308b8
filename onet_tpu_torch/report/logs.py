"""Structured run logging, format-compatible with the reference
(``onet_tpu/report/logs.py``).

The reference greps its own logs afterwards (get_res_from_log /
get_dr_far_list_from_log, uti_zy3_test_20240123.py:681-749), so the epoch
line format is load-bearing:

  "<model>===Epoch: %04d loss: %.5f, lr: %.10f, acc:%.4f, miou:%.4f,
   target_iou:%.4f, dr:%.4f, far:%.2E, <timestamp>"
  (Train_Onet_on_simclutter_20250407.py:242-247)

``mine_epoch_metrics`` is the matching parser.
"""

from __future__ import annotations

import logging
import os
import re
from datetime import datetime
from typing import Dict, List


def setup_logging(out_root: str, model_name: str) -> str:
    os.makedirs(out_root, exist_ok=True)
    mark = datetime.now().strftime("%Y_%m%d_%H")
    log_file = os.path.join(out_root, f"{model_name}_{mark}.log")
    logging.basicConfig(filename=log_file, level=logging.INFO, force=True)
    return log_file


def epoch_log_line(model_name: str, epoch: int, loss: float, lr: float,
                   metrics: Dict[str, float]) -> str:
    return (
        "%s===Epoch: %04d loss: %.5f, lr: %.10f, acc:%.4f, miou:%.4f, "
        "target_iou:%.4f, dr:%.4f, far:%.2E, %s"
        % (model_name, epoch, loss, lr,
           metrics.get("acc", float("nan")), metrics.get("miou", float("nan")),
           metrics.get("tiou", float("nan")), metrics.get("dr", float("nan")),
           metrics.get("far", float("nan")), datetime.now())
    )


_EPOCH_RE = re.compile(
    r"===Epoch:\s*(\d+)\s+loss:\s*([-\d.eE+]+),\s*lr:\s*([-\d.eE+]+),\s*"
    r"acc:([-\d.eE+]+),\s*miou:([-\d.eE+]+),\s*target_iou:([-\d.eE+]+),\s*"
    r"dr:([-\d.eE+]+),\s*far:([-\d.eE+]+)"
)


def mine_epoch_metrics(log_path: str) -> List[Dict[str, float]]:
    """Parse epoch lines back out of a log file (the reference's log-mining
    workflow)."""
    rows = []
    with open(log_path) as f:
        for line in f:
            m = _EPOCH_RE.search(line)
            if m:
                e, loss, lr, acc, miou, tiou, dr, far = m.groups()
                rows.append({
                    "epoch": int(e), "loss": float(loss), "lr": float(lr),
                    "acc": float(acc), "miou": float(miou),
                    "tiou": float(tiou), "dr": float(dr), "far": float(far),
                })
    return rows


def dr_far_curve(rows: List[Dict[str, float]]):
    """(dr_list, far_list) from mined epoch rows — the reference's
    get_dr_far_list_from_log output used for Pd/FAR curves."""
    return [r["dr"] for r in rows], [r["far"] for r in rows]


def average_pd_by_far_decade(rows: List[Dict[str, float]]) -> Dict[int, float]:
    """Mean detection rate binned by floor(log10(far)) — the reference's
    compute_ave_pd_in_order_of_magnitude (uti_zy3_test_20240123.py:751-771)."""
    import math

    bins: Dict[int, List[float]] = {}
    for r in rows:
        far = r["far"]
        if far <= 0:
            continue
        decade = int(math.floor(math.log10(far)))
        bins.setdefault(decade, []).append(r["dr"])
    return {d: sum(v) / len(v) for d, v in sorted(bins.items())}


def format_latex_table(rows: List[Dict[str, float]],
                       keys=("acc", "miou", "dr", "far")) -> str:
    """Metric rows -> a LaTeX tabular body (reference format_latex_table)."""
    lines = [" & ".join(keys) + r" \\"]
    for r in rows:
        cells = []
        for k in keys:
            v = r.get(k, float("nan"))
            cells.append("%.2E" % v if k == "far" else "%.4f" % v)
        lines.append(" & ".join(cells) + r" \\")
    return "\n".join(lines)
