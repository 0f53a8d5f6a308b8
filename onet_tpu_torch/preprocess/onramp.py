"""ZY-3 raw-imagery on-ramp and preprocessing selection
(``onet_tpu/preprocess/onramp.py``).

The reference's full ZY-3 test-set pipeline
(test_pre_processing_on_zy3_testset_20240607.py:506-562): a directory of
raw RGB scenes and mask PNGs becomes Resize(300)/CenterCrop(224)
thumbnails (make_thrumnail_image :99-184 / make_thumnail_mask :186-212);
the model scores every preprocessing option per image and the best-mIoU
variant is kept (choose_test_preprocess :359-472, an ORACLE protocol: the
selection consults ground truth), or the fixed per-cloud-class option is
applied (classified_preprocess :261-357); the results land in the
reference's dict-of-dicts ``.pt`` schema and a per-image xlsx report.

Instead of nine single-image forwards per scene, all variants of one image
are stacked into one batch and scored by one forward
(``curation.score_variants``); the haze terms run on the device. Images
are decoded by PIL on the host and moved to ``device`` (default: the
card) once.
"""

from __future__ import annotations

import glob as globmod
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.preprocess.curation import (CLASSIFIED_OPTIONS,
                                                make_thumbnail_mask,
                                                score_variants)
from onet_tpu_torch.preprocess.image import (PRE_OPTIONS, apply_pre_option,
                                             thumbnail_rgb)
from onet_tpu_torch.utils.summary import scr_db

# The reference applies its strongest option only to the one scene it was
# tuned on (choose_test_preprocess :412-413)
STRONG_OPTION = "contrast_enhance_haze_enhance"
STRONG_OPTION_ID = "1706158599"


def id_from_filename(path: str) -> str:
    """The reference's filename-id convention (:101-105): the last
    '_'-separated token before the extension, or the second-to-last when
    the name carries a 'pre' tag."""
    name = os.path.basename(path)
    if "pre" in name:
        return name.split("_")[-2]
    return name.split("_")[-1].split(".")[0]


def load_image_u8(path: str, device=None) -> torch.Tensor:
    """Decode an image file to uint8 [H, W, 3] on ``device`` (default: the
    card); grayscale scenes are L->RGB converted like the reference."""
    from PIL import Image

    dev = resolve_device(device)
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return torch.from_numpy(np.array(img, np.uint8)).to(dev)


def list_scene_files(src_dir: str,
                     exts: Sequence[str] = ("jpg", "JPG", "png", "jpeg"),
                     ) -> List[str]:
    """Sorted scene files of a directory (the reference globs *.jpg and
    *.JPG, then sorts)."""
    files: List[str] = []
    for e in exts:
        files.extend(globmod.glob(os.path.join(src_dir, f"*.{e}")))
    return sorted(set(files))


def _scene(sf: str, mf: Optional[str], resize_to: int, crop: int, dev):
    """(id, uint8 thumbnail, mask thumbnail or None) of one scene file and
    its mask file."""
    pid = id_from_filename(sf)
    u8 = thumbnail_rgb(load_image_u8(sf, dev), resize_to=resize_to,
                       crop=crop)
    if mf is None:
        return pid, u8, None
    mid = id_from_filename(mf)
    if mid != pid:
        raise ValueError(f"scene id {pid} != mask id {mid} ({sf} vs {mf})")
    lab = make_thumbnail_mask(load_image_u8(mf, dev)[..., 0], pid,
                              resize_to=resize_to, crop=crop)
    return pid, u8, lab


def prepare_zy3_thumbnails(src_files: Sequence[str],
                           mask_files: Optional[Sequence[str]] = None,
                           *, pre_option: str = "raw_rgb",
                           resize_to: int = 300, crop: int = 224,
                           device=None) -> Tuple[Dict[str, dict], List[str]]:
    """Raw scenes -> {id: {'img' f32 [H, W, 3], 'u8', 'mask' f32 [H, W]}}
    on ``device``: Resize(smaller edge)/CenterCrop thumbnails with any of
    the nine preprocessing options, masks binarized at 0.5 (the
    id-1706158599 all-ones hack kept)."""
    if mask_files is not None and len(mask_files) != len(src_files):
        raise ValueError(f"{len(src_files)} scenes but {len(mask_files)} "
                         "masks; the reference pairs them by sorted order")
    dev = resolve_device(device)
    prepared: Dict[str, dict] = {}
    ids: List[str] = []
    for i, f in enumerate(src_files):
        pid, u8, lab = _scene(f, None if mask_files is None
                              else mask_files[i], resize_to, crop, dev)
        rec = {"img": apply_pre_option(u8, pre_option), "u8": u8}
        if lab is not None:
            rec["mask"] = lab
        prepared[pid] = rec
        ids.append(pid)
    return prepared, ids


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu() if torch.is_tensor(t) else t, np.float32)


def save_zy3_dict(path: str, prepared: Dict[str, dict],
                  id_prefix: str = "") -> str:
    """Persist thumbnails in the reference's schema. ``.pt``: the
    dict-of-dicts {id: {'true_color' [3, H, W], 'mask' [H, W]}} that
    ``data/zy3.py::load_zy3_dict_pt`` reads, with any per-image metadata
    (opt/acc/miou/snr) alongside; ``.npz``: the imgs/labels arrays and the
    ids."""
    keys = list(prepared)
    if path.endswith(".pt"):
        out = {}
        for k in keys:
            rec = prepared[k]
            entry = {"true_color": torch.from_numpy(np.ascontiguousarray(
                _host(rec["img"]).transpose(2, 0, 1)))}
            if rec.get("mask") is not None:
                entry["mask"] = torch.from_numpy(_host(rec["mask"]))
            for meta in ("opt", "acc", "miou", "org_snr", "org_scr",
                         "pre_snr", "pre_scr", "classified_type"):
                if meta in rec:
                    entry[meta] = rec[meta]
            out[id_prefix + k] = entry
        torch.save(out, path)
        return path
    arrays = {"imgs": np.stack([_host(prepared[k]["img"]) for k in keys])}
    if all(prepared[k].get("mask") is not None for k in keys):
        arrays["labels"] = np.stack([_host(prepared[k]["mask"])
                                     for k in keys])
    np.savez(path, ids=np.asarray(keys), **arrays)
    return path


def _variant_options(pid: str, options: Sequence[str]) -> List[str]:
    return [o for o in options
            if o != STRONG_OPTION or pid == STRONG_OPTION_ID]


def _groups_of(groups) -> Dict[str, str]:
    return {str(i): g for g, id_list in (groups or {}).items()
            for i in id_list}


def _scored(params, bn_state, u8, lab, opts, policy, forward):
    """Score the variants ``opts`` of one thumbnail: one forward, one host
    read. Returns (the variant stack, accs, mious, org_snr, pre_snr) with
    the SNRs of the raw image and of the best-mIoU variant. ``forward``
    swaps in another backbone family's forward (``models/arch.py``)."""
    stack = torch.stack([apply_pre_option(u8, o) for o in opts])
    accs, mious = score_variants(params, bn_state, stack, lab, policy=policy,
                                 forward=forward)
    k = torch.argmax(mious)               # the first best, as a stable sort
    org = scr_db(apply_pre_option(u8, "raw_rgb"), lab[..., None])
    pre = scr_db(stack[k], lab[..., None])
    vals = torch.cat([accs, mious, torch.stack([org, pre])]).double().tolist()
    n = len(opts)
    return stack, vals[:n], vals[n:2 * n], vals[2 * n], vals[2 * n + 1]


def _record(img, lab, opt, acc, mi, org_snr, pre_snr, ctype):
    return {"img": img, "mask": lab, "opt": opt, "acc": acc, "miou": mi,
            "org_snr": org_snr, "org_scr": org_snr, "pre_snr": pre_snr,
            "pre_scr": pre_snr, "classified_type": ctype}


def _row(key, rec):
    return {"img_id": key, "miou": rec["miou"], "acc": rec["acc"],
            "opt": rec["opt"], "org_snr": rec["org_snr"],
            "pre_snr": rec["pre_snr"],
            "classified_type": rec["classified_type"]}


def choose_preprocess(params, bn_state, src_files: Sequence[str],
                      mask_files: Sequence[str], *,
                      groups: Optional[Dict[str, List[str]]] = None,
                      options: Sequence[str] = PRE_OPTIONS,
                      policy: Policy = DEFAULT, forward=None,
                      id_prefix: str = "zy3_test_",
                      resize_to: int = 300, crop: int = 224,
                      progress: bool = False, device=None,
                      ) -> Tuple[Dict[str, dict], List[dict]]:
    """The oracle selection workload: per scene, every admissible variant
    scored in one forward; the best-mIoU one kept with its acc, option,
    raw-vs-preprocessed SNR/SCR and cloud class (and the raw_rgb scores as
    base_acc / base_miou where raw_rgb is an option). Returns (best dict
    keyed ``id_prefix + id``, per-image rows sorted by mIoU, best
    first)."""
    dev = resolve_device(device)
    id_to_group = _groups_of(groups)
    best: Dict[str, dict] = {}
    rows: List[dict] = []
    for i, (sf, mf) in enumerate(zip(src_files, mask_files)):
        pid, u8, lab = _scene(sf, mf, resize_to, crop, dev)
        opts = _variant_options(pid, options)
        stack, accs, mious, org, pre = _scored(params, bn_state, u8, lab,
                                               opts, policy, forward)
        k = max(range(len(opts)), key=lambda j: (mious[j], -j))
        key = id_prefix + pid
        ctype = id_to_group.get(key, id_to_group.get(pid, ""))
        rec = _record(stack[k], lab, opts[k], accs[k], mious[k], org, pre,
                      ctype)
        row = _row(key, rec)
        if "raw_rgb" in opts:
            bi = opts.index("raw_rgb")
            rec["base_acc"] = row["base_acc"] = accs[bi]
            rec["base_miou"] = row["base_miou"] = mious[bi]
        best[key] = rec
        rows.append(row)
        if progress:
            print(f"[choose-preprocess] {i + 1}/{len(src_files)} {pid}: "
                  f"{opts[k]} miou {rec['miou']:.4f} acc {rec['acc']:.4f}")
    rows.sort(key=lambda r: r["miou"], reverse=True)
    return best, rows


def classified_choose(params, bn_state, src_files: Sequence[str],
                      mask_files: Sequence[str],
                      groups: Dict[str, List[str]], *,
                      assignment: Dict[str, str] = CLASSIFIED_OPTIONS,
                      policy: Policy = DEFAULT, forward=None,
                      id_prefix: str = "zy3_test_",
                      resize_to: int = 300, crop: int = 224, device=None,
                      ) -> Tuple[Dict[str, dict], List[dict]]:
    """The fixed per-cloud-class mode: normal/thin clouds get
    haze_enhance, snow gets contrast_enhance_haze_remove; each scene is
    scored once with its assigned option."""
    dev = resolve_device(device)
    id_to_group = _groups_of(groups)
    best: Dict[str, dict] = {}
    rows: List[dict] = []
    for sf, mf in zip(src_files, mask_files):
        pid, u8, lab = _scene(sf, mf, resize_to, crop, dev)
        key = id_prefix + pid
        ctype = id_to_group.get(key, id_to_group.get(pid, ""))
        opt = assignment.get(ctype, "raw_rgb")
        stack, accs, mious, org, pre = _scored(params, bn_state, u8, lab,
                                               [opt], policy, forward)
        best[key] = _record(stack[0], lab, opt, accs[0], mious[0], org, pre,
                            ctype)
        rows.append(_row(key, best[key]))
    rows.sort(key=lambda r: r["miou"], reverse=True)
    return best, rows


def write_preprocess_report(path: str, rows: List[dict]) -> str:
    """Per-image xlsx report (the reference's
    zy3_testset50_best_preprocess202406.xlsx) through the port's OOXML
    writer."""
    from onet_tpu_torch.report.xlsx import Workbook

    wb = Workbook()
    ws = wb.add_sheet("best_preprocess")
    cols = ["img_id", "opt", "acc", "miou", "org_snr", "pre_snr",
            "classified_type"]
    ws.write_row(1, cols)
    for r, row in enumerate(rows, start=2):
        ws.write_row(r, [row.get(c, "") for c in cols])
    if rows:
        mean_acc = float(np.mean([r["acc"] for r in rows]))
        mean_miou = float(np.mean([r["miou"] for r in rows]))
        ws.write_row(len(rows) + 3, ["mean", "", mean_acc, mean_miou])
    return wb.save(path)
