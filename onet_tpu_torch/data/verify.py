"""Real-data conformance kit: check a reference-schema ``.pt`` drop-in
before training (``onet_tpu/data/verify.py``).

Real imagery comes in one of the reference's three torch-pickle schemas
(dataloader/zy3_cloud_thumbnailv5_20240304.py:80-106 dict-of-dicts,
nau_rain_20230523.py:12-38 {id: {img, label}}, simbg4onet_20230209.py:
106-112 {bg}_imgs / {bg}_labels / psnr). ``verify_dataset`` detects the
schema, checks its key / dtype / shape contract, computes sanity stats
(value ranges, mask levels, a NaN/Inf scan) on the host, and runs one
eval batch through the port's loader and ``onet_forward`` on the card to
show the file is consumable end to end. The issues and their messages
are the JAX package's; frames or masks of two shapes are reported as
such, where the JAX verifier stops at stacking them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import DEFAULT
from onet_tpu_torch.models.onet import (compute_loss, onet_forward,
                                        onet_init, predict_label)


class ConformanceError(ValueError):
    """A schema-contract violation with an actionable message."""


def _detect_workload(d) -> str:
    """Which reference schema a loaded .pt object carries."""
    if isinstance(d, dict) and d and all(isinstance(v, dict)
                                         for v in d.values()):
        first = next(iter(d.values()))
        if "true_color" in first:
            return "zy3"
        if "img" in first and "label" in first:
            return "nau"
        raise ConformanceError(
            "dict-of-dicts .pt but entries carry neither 'true_color' "
            f"(zy3) nor 'img'/'label' (nau); first entry keys: "
            f"{sorted(first)}")
    if isinstance(d, dict):
        if any(k.endswith("_imgs") for k in d):
            return "simclutter"
        raise ConformanceError(
            "flat dict .pt without a '*_imgs' key (simclutter schema "
            f"needs {{bg}}_imgs/{{bg}}_labels/psnr); keys: {sorted(d)[:8]}")
    raise ConformanceError(f".pt top level is {type(d).__name__}, "
                           "expected a dict")


def _stats(name: str, a: np.ndarray, issues: List[str], *,
           binary: bool = False) -> dict:
    finite = np.isfinite(a)
    if not finite.all():
        issues.append(f"{name}: {int((~finite).sum())} non-finite values")
    s = {"shape": list(a.shape), "dtype": str(a.dtype),
         "min": float(a.min()), "max": float(a.max()),
         "mean": float(a.mean())}
    if binary:
        levels = np.unique(a)
        s["levels"] = [float(v) for v in levels[:6]]
        if not set(np.round(levels.astype(np.float64), 6)) <= {0.0, 1.0, 2.0}:
            issues.append(f"{name}: mask levels {levels[:6]} not in "
                          "{0,1,2} (binary/3-class contract)")
    return s


def _check(cond: bool, msg: str, issues: List[str]):
    if not cond:
        issues.append(msg)


def verify_dataset(path: str, workload: str = "auto", *,
                   eval_batch: bool = True, base: Optional[int] = None,
                   policy=None, device=None) -> dict:
    """Check ``path`` against its reference schema; return a report.

    Report: {path, workload, n, issues: [...], ok, per-key stats, eval:
    {batch, loss, mask_mean} when the one-batch forward ran (on ``device``,
    default the card; raises without one)}. Raises ConformanceError only
    for a file that cannot be identified at all; contract violations are
    collected in ``issues`` so one run reports every problem. The file
    holds strings and lists beside its tensors, so it is unpickled in
    full (``weights_only=False``): verify only files you trust."""
    dev = resolve_device(device) if eval_batch else None
    d = torch.load(path, map_location="cpu", weights_only=False)
    wl = _detect_workload(d) if workload in (None, "auto") else workload
    issues: List[str] = []
    report = {"path": path, "workload": wl}

    if wl == "simclutter":
        img_key = next((k for k in d if k.endswith("_imgs")), None)
        lab_key = next((k for k in d if k.endswith("_labels")), None)
        _check(img_key is not None, "missing '{bg}_imgs' key", issues)
        _check(lab_key is not None, "missing '{bg}_labels' key", issues)
        _check("psnr" in d, "missing 'psnr' key (per-frame SNR list, "
               "simbg4onet_20230209.py:108)", issues)
        if img_key and lab_key:
            imgs = np.asarray(d[img_key])
            labs = np.asarray(d[lab_key])
            _check(imgs.ndim == 4 and imgs.shape[1] == 1,
                   f"{img_key}: expected [N,1,H,W] NCHW, got "
                   f"{list(imgs.shape)}", issues)
            _check(labs.ndim == 3, f"{lab_key}: expected [N,H,W], got "
                   f"{list(labs.shape)}", issues)
            _check(len(imgs) == len(labs),
                   f"{len(imgs)} imgs vs {len(labs)} labels", issues)
            if "psnr" in d:
                _check(len(np.asarray(d["psnr"])) == len(imgs),
                       f"psnr length {len(np.asarray(d['psnr']))} != "
                       f"{len(imgs)} frames", issues)
            report["imgs"] = _stats(img_key, imgs, issues)
            report["labels"] = _stats(lab_key, labs, issues, binary=True)
            report["n"] = int(len(imgs))
    else:
        ids = list(d)
        report["n"] = len(ids)
        img_field, lab_field = (("true_color", "mask") if wl == "zy3"
                                else ("img", "label"))
        missing = [i for i in ids if img_field not in d[i]]
        _check(not missing, f"{len(missing)} entries missing "
               f"'{img_field}' (e.g. {missing[:3]})", issues)
        lab_missing = [i for i in ids if lab_field not in d[i]]
        if wl == "nau":
            _check(not lab_missing, f"{len(lab_missing)} entries missing "
                   f"'{lab_field}'", issues)
        elif lab_missing and len(lab_missing) != len(ids):
            issues.append(f"{len(lab_missing)}/{len(ids)} entries missing "
                          "'mask' — must be all-or-none for the loader")
        good = [i for i in ids if img_field in d[i]]
        if good:
            imgs = [np.asarray(d[i][img_field]) for i in good]
            shapes = {a.shape for a in imgs}
            _check(len(shapes) == 1, f"inconsistent image shapes {shapes}",
                   issues)
            a0 = imgs[0]
            if wl == "zy3":
                _check(a0.ndim == 3 and a0.shape[0] == 3,
                       f"'true_color': expected [3,H,W] CHW, got "
                       f"{list(a0.shape)} "
                       "(zy3_cloud_thumbnailv5_20240304.py:80-106)", issues)
            else:
                _check(a0.ndim == 2, f"'img': expected [H,W], got "
                       f"{list(a0.shape)} (nau_rain_20230523.py:12-38)",
                       issues)
            if len(shapes) == 1:        # frames of two shapes do not stack
                report["imgs"] = _stats(img_field, np.stack(imgs), issues)
        labs = [np.asarray(d[i][lab_field]) for i in ids
                if lab_field in d[i]]
        if labs:
            same = all(a.shape == labs[0].shape for a in labs)
            _check(same, "inconsistent mask shapes", issues)
            if same:
                report["labels"] = _stats(lab_field, np.stack(labs), issues,
                                          binary=True)

    if eval_batch and not issues:
        report["eval"] = _eval_one_batch(path, wl, base=base, policy=policy,
                                         device=dev)
    report["issues"] = issues
    report["ok"] = not issues
    return report


def _eval_one_batch(path: str, wl: str, *, base: Optional[int] = None,
                    policy=None, device=None) -> dict:
    """Show the file is consumable: load it through the port's loader on
    ``device`` and run one forward and loss on its first two frames with a
    fresh (untrained) model, base 64 on the card and 8 on the CPU."""
    dev = resolve_device(device)
    if wl == "simclutter":
        from onet_tpu_torch.data.simclutter import load_simclutter_pt
        ds = load_simclutter_pt(path, device=dev)
    elif wl == "zy3":
        from onet_tpu_torch.data.zy3 import load_zy3_dict_pt
        ds, _ = load_zy3_dict_pt(path, device=dev)
    else:
        from onet_tpu_torch.data.nau import load_nau_dict_pt
        ds, _ = load_nau_dict_pt(path, device=dev)
    x = ds["imgs"][: min(2, len(ds["imgs"]))]
    cin = int(x.shape[-1])
    params, state = onet_init(
        torch.Generator().manual_seed(0), cin,
        base=base or (8 if dev.type == "cpu" else 64), device=dev)
    policy = policy or DEFAULT
    with torch.inference_mode(), policy.precision():
        out, _ = onet_forward(params, state, x, train=False, policy=policy)
        loss, mask = compute_loss(out), predict_label(out.S)
        return {"batch": list(x.shape), "loss": float(loss),
                "mask_mean": float(mask.float().mean())}


def format_report(report: dict) -> str:
    lines = [f"[verify-data] {report['path']}: workload={report['workload']}"
             f" n={report.get('n', '?')}"]
    for key in ("imgs", "labels"):
        if key in report:
            s = report[key]
            extra = (f" levels={s['levels']}" if "levels" in s else "")
            lines.append(
                f"  {key}: shape {s['shape']} {s['dtype']} "
                f"range [{s['min']:.4g}, {s['max']:.4g}] "
                f"mean {s['mean']:.4g}{extra}")
    if "eval" in report:
        e = report["eval"]
        lines.append(f"  eval batch {e['batch']}: loss {e['loss']:.4f} "
                     f"mask_mean {e['mask_mean']:.4f}")
    for issue in report["issues"]:
        lines.append(f"  FAIL: {issue}")
    lines.append("  OK — schema conforms; loader and forward both consume "
                 "this file" if report["ok"] else
                 f"  {len(report['issues'])} contract violation(s)")
    return "\n".join(lines)
