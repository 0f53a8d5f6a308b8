"""Tabular result reports (``onet_tpu/report/tables.py``).

The reference's save_zy3_test_results_to_excel (uti_zy3_test_20240123.py:
320-429): per-image rows plus per-group (normal / thin / snow cloud)
means, and save_results_to_excel / save_image_to_cell (:541-591), which
embed 50x50 rgb/label/pred/vt/vd thumbnails in columns I-M of each image's
row. .xlsx output goes through the port's OOXML writer (report/xlsx.py);
CSV remains available for plain tables. The rows and summaries are pandas
DataFrames of host values, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from onet_tpu_torch.report.xlsx import Workbook


def per_image_table(ids: Sequence[str], per_img: Dict[str, np.ndarray]) -> pd.DataFrame:
    df = pd.DataFrame({"img_id": list(ids)})
    for k, v in per_img.items():
        df[k] = np.asarray(v)
    return df


def grouped_summary(df: pd.DataFrame,
                    groups: Dict[str, List[str]]) -> pd.DataFrame:
    """Mean metrics per divided-testset group (normal/thin/snow...)."""
    rows = []
    metric_cols = [c for c in df.columns if c != "img_id"]
    for name, ids in groups.items():
        sub = df[df["img_id"].isin(ids)]
        row = {"group": name, "n": len(sub)}
        row.update({c: float(sub[c].mean()) if len(sub) else float("nan")
                    for c in metric_cols})
        rows.append(row)
    row = {"group": "all", "n": len(df)}
    row.update({c: float(df[c].mean()) for c in metric_cols})
    rows.append(row)
    return pd.DataFrame(rows)


def _df_to_sheet(ws, df: pd.DataFrame) -> None:
    ws.write_row(1, list(df.columns))
    for i, (_, row) in enumerate(df.iterrows(), start=2):
        ws.write_row(i, [v if isinstance(v, (int, float, np.integer,
                                             np.floating)) else str(v)
                         for v in row.tolist()])


def save_report(out_path: str, df: pd.DataFrame,
                summary: Optional[pd.DataFrame] = None) -> str:
    """Write the report: .xlsx via the in-repo OOXML writer, else CSV."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if out_path.endswith(".xlsx"):
        wb = Workbook()
        _df_to_sheet(wb.add_sheet("all"), df)
        if summary is not None:
            _df_to_sheet(wb.add_sheet("summary"), summary)
        return wb.save(out_path)
    df.to_csv(out_path, index=False)
    if summary is not None:
        summary.to_csv(out_path[:-4] + "_summary.csv", index=False)
    return out_path


# thumbnail layout of the reference report (uti_zy3_test_20240123.py:573-583):
# metric columns first, images in columns I..M headed rgb/label/pred/vt/vd
_IMG_COLS = {"rgb": 9, "label": 10, "pred": 11, "vt": 12, "vd": 13}
_THUMB_PX = 50


def save_zy3_excel_report(out_path: str, rows: List[dict],
                          summary: Optional[pd.DataFrame] = None) -> str:
    """Excel report with embedded thumbnails, reference layout.

    ``rows``: one dict per test image with scalar fields (``img_id``,
    ``acc``, ``miou``, ``group`` ...) and optional image fields ``rgb``
    (HxWx3), ``label``/``pred``/``vt``/``vd`` (HxW), floats in [0,1].
    Images land as 50x50 thumbnails in columns I-M of the image's row,
    exactly like save_image_to_cell (uti_zy3_test_20240123.py:541-553).
    A ``summary`` DataFrame (per-group means) goes to a second sheet.
    """
    wb = Workbook()
    ws = wb.add_sheet("Sheet1")
    scalar_keys = [k for k in rows[0] if k not in _IMG_COLS] if rows else []
    ws.write_row(1, scalar_keys)
    for name, col in _IMG_COLS.items():
        ws.cell(1, col, name)
        ws.set_column_width(col, _THUMB_PX / 7.0)  # ~px-to-char width
    for i, r in enumerate(rows, start=2):
        ws.write_row(i, [r.get(k, "") for k in scalar_keys])
        ws.set_row_height(i, _THUMB_PX * 0.75)     # px-to-points
        for name, col in _IMG_COLS.items():
            if name in r and r[name] is not None:
                ws.add_image(np.asarray(r[name]), i, col,
                             _THUMB_PX, _THUMB_PX)
    if summary is not None:
        _df_to_sheet(wb.add_sheet("summary"), summary)
    return wb.save(out_path)


def sort_results(rows, key: str = "acc", ascending: bool = True):
    """Per-image result rows sorted by a metric (the reference's
    print_sorted_results ordering for worst-case inspection)."""
    return sorted(rows, key=lambda r: r.get(key, float("nan")),
                  reverse=not ascending)
