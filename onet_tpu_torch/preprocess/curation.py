"""Dataset curation and per-image preprocessing selection
(``onet_tpu/preprocess/curation.py``).

* ``segment_trainset_report``: run the model over a trainset and record
  each image's foreground coverage for manual division
  (select_trainset_for_correct_clouds_20240307.py:57-92);
* ``divide_by_id_lists`` / ``load_division_table``: filter a dataset by
  id-group tables (CSV, or xlsx sheets per group when pandas has an
  engine);
* ``choose_best_preprocess``: for each image, try every preprocessing
  option and keep the best-mIoU variant. This selection consults ground
  truth: an ORACLE evaluation protocol, not inference, as in the
  reference (choose_test_preprocess, :359-472);
* ``classified_preprocess``: a fixed option per cloud class (:261-357).

All variants of one image are scored in one batched forward (eval-mode
BatchNorm scores each frame alone, so the batch changes nothing); one
host read per image.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.metrics.segmentation import accuracy, miou
from onet_tpu_torch.models.onet import onet_forward, predict_label
from onet_tpu_torch.preprocess.image import (
    PRE_OPTIONS, apply_pre_option, center_crop_hw, rgb_resize_smaller_edge)

CLASSIFIED_OPTIONS = {
    # classified_preprocess's fixed assignment (:261-357)
    "normal_cloud": "haze_enhance",
    "thin_cloud": "haze_enhance",
    "snow_cloud": "contrast_enhance_haze_remove",
}


def _predict(params, bn_state, x, policy: Policy, forward=None):
    with torch.no_grad(), policy.precision():
        out, _ = (forward or onet_forward)(params, bn_state, x, train=False,
                                           policy=policy)
        return predict_label(out.S)


def segment_trainset_report(params, bn_state, ds: ArrayDataset,
                            ids: Sequence[str], batch_sz: int = 5, *,
                            policy: Policy = DEFAULT):
    """[{img_id, fg_coverage}] rows for manual trainset division: the
    share of each image's minority predicted class."""
    covs = []
    for lo in range(0, len(ds), batch_sz):
        pred = _predict(params, bn_state, ds["imgs"][lo:lo + batch_sz],
                        policy)
        cov = pred.to(torch.float32).mean(dim=(1, 2))
        covs.append(torch.minimum(cov, 1 - cov))
    vals = torch.cat(covs).tolist()
    return [{"img_id": ids[i], "fg_coverage": c} for i, c in enumerate(vals)]


def divide_by_id_lists(ds: ArrayDataset, ids: Sequence[str],
                       keep_ids: Sequence[str]):
    """Subset a dataset to the ids in ``keep_ids`` (in the order of ``ids``)."""
    want = set(keep_ids)
    keep = [i for i, name in enumerate(ids) if name in want]
    sub = ds.select(torch.tensor(keep, dtype=torch.int64, device=ds.device))
    return sub, [ids[i] for i in keep]


def load_division_table(path: str, group_col: str = "group",
                        id_col: str = "img_id") -> Dict[str, List[str]]:
    """Read a division table (CSV, or xlsx sheets named per group)."""
    import pandas as pd

    if path.endswith(".xlsx"):
        sheets = pd.read_excel(path, sheet_name=None)
        return {name: df[id_col].astype(str).tolist()
                for name, df in sheets.items()}
    df = pd.read_csv(path)
    return {g: sub[id_col].astype(str).tolist()
            for g, sub in df.groupby(group_col)}


def score_variants(params, bn_state, x: torch.Tensor, lab: torch.Tensor, *,
                   policy: Policy = DEFAULT, forward=None):
    """One forward over the [K, H, W, 3] variant stack of one image;
    per-variant (acc [K], miou [K]) of the RAW argmax against the shared
    mask [H, W] (the reference scores it with no reorder). ``forward``:
    another backbone family's forward (``models/arch.py``)."""
    pred = _predict(params, bn_state, x, policy, forward)
    lab = lab.expand_as(pred)
    return (torch.func.vmap(accuracy)(pred, lab),
            torch.func.vmap(miou)(pred, lab))


def choose_best_preprocess(params, bn_state, u8_images: Sequence[torch.Tensor],
                           labels: Sequence[torch.Tensor],
                           ids: Sequence[str],
                           options: Sequence[str] = PRE_OPTIONS, *,
                           policy: Policy = DEFAULT):
    """ORACLE protocol: per image (uint8 [H, W, 3]), keep the option with
    the best mIoU against its labels, the first such option on ties.
    Returns (best {id: {img, option, acc, miou}}, table rows)."""
    best, rows = {}, []
    for u8, lab, name in zip(u8_images, labels, ids):
        stack = torch.stack([apply_pre_option(u8, o) for o in options])
        accs, mious = score_variants(params, bn_state, stack, lab,
                                     policy=policy)
        accs, mious = torch.stack([accs, mious]).double().tolist()
        for o, a, m in zip(options, accs, mious):
            rows.append({"img_id": name, "option": o, "acc": a, "miou": m})
        k = max(range(len(options)), key=lambda i: (mious[i], -i))
        best[name] = {"img": stack[k], "option": options[k],
                      "acc": accs[k], "miou": mious[k]}
    return best, rows


def classified_preprocess(u8_images: Sequence[torch.Tensor],
                          ids: Sequence[str],
                          groups: Dict[str, List[str]],
                          assignment: Dict[str, str] = CLASSIFIED_OPTIONS):
    """Fixed per-class preprocessing (no oracle): returns {id: img}."""
    id_to_group = {i: g for g, id_list in groups.items() for i in id_list}
    return {name: apply_pre_option(
                u8, assignment.get(id_to_group.get(name, ""), "raw_rgb"))
            for u8, name in zip(u8_images, ids)}


def make_thumbnail_mask(mask_img: torch.Tensor, img_id: str = "", *,
                        resize_to: int = 300, crop: int = 224) -> torch.Tensor:
    """Mask thumbnail: resize + center crop + binarize at 0.5 -> float32
    [crop, crop]; id '1706158599' is forced to all ones (the reference's
    hack for that scene)."""
    m = mask_img if mask_img.ndim == 3 else mask_img[..., None]
    m = (m.to(torch.uint8) * 255 if bool(m.max() <= 1)
         else m.to(torch.uint8))
    m = center_crop_hw(rgb_resize_smaller_edge(m, resize_to), crop)
    m = (m[..., 0].to(torch.float32) / 255.0 > 0.5).to(torch.float32)
    return torch.ones_like(m) if img_id == "1706158599" else m
