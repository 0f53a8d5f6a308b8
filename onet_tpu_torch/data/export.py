"""Reference-schema ``.pt`` dataset export (``onet_tpu/data/export.py``).

Datasets generated on the card are written in the torch ``.pt`` schemas
the reference's loaders read, so a reference user can swap its host-side
generation (Rayleigh_bg_Gaussian_EOT_generator_20230208.py:295-325) for
the card's and keep every downstream script. The port's dataset dicts of
tensors, on any device, go in; the files hold the same keys, dtypes,
layouts, ids and ``desc`` as the JAX package's:

* simclutter: ``{'<bg>_imgs': float32 [N,1,H,W], '<bg>_labels': float32
  [N,H,W], 'psnr': list[int], 'desc': str}`` (prepare_data,
  Rayleigh_bg_...:312-325; make_simbg_dataloader,
  dataloader/simbg4onet_20230209.py:106-112);
* ZY-3: ``{img_id: {'true_color': float32 [3,H,W], 'mask': float32
  [H,W]}}`` (dataloader/zy3_cloud_thumbnailv5_20240304.py:80-106);
* NAU rain: ``{name: {'img': float32 [H,W], 'label': float32 [H,W]}}``
  (dataloader/nau_rain_20230523.py:12-38).

Every tensor comes off the card and owns its memory before ``torch.save``
(a saved view would carry its whole base).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _host(t) -> torch.Tensor:
    """A float32 CPU copy that owns its memory."""
    return torch.as_tensor(t).detach().to(
        "cpu", torch.float32, copy=True,
        memory_format=torch.contiguous_format)


def _has_labels(ds) -> bool:
    return "labels" in getattr(ds, "data", ds)


def export_simclutter_pt(path: str, data, *, bg: str = "rayleigh",
                         desc: Optional[str] = None) -> str:
    """Write a simclutter dataset in the reference's ``.pt`` schema.

    ``data``: a mapping (or ``ArrayDataset``) with ``imgs`` [N, H, W, 1]
    (NHWC, the port's layout), ``labels`` [N, H, W] and ``psnr`` [N], as
    ``generate_rayleigh_dataset`` returns. The images are written NCHW.
    The alias ``bg='k'`` maps to the reference's ``kdist_*`` keys
    ('%s_imgs' % bg_type, Rayleigh_bg_...::prepare_data); the reference's
    own loader reads ``rayleigh_imgs`` only."""
    bg = {"k": "kdist"}.get(bg, bg)
    imgs = _host(data["imgs"]).permute(0, 3, 1, 2).contiguous()
    labels = _host(data["labels"])
    psnr = [int(p) for p in torch.as_tensor(data["psnr"]).cpu().tolist()]
    n_levels = len(set(psnr))
    if desc is None:
        sim = "kdist" if bg == "kdist" else "rayleigh"
        desc = (f"{bg} clutter + extended targets, device-generated by "
                f"onet-tpu (sim/{sim}.py); "
                f"{len(psnr)} frames over {n_levels} psnr levels; schema of "
                f"Rayleigh_bg_Gaussian_EOT_generator_20230208.py:312-314")
    torch.save({f"{bg}_imgs": imgs, f"{bg}_labels": labels, "psnr": psnr,
                "desc": desc}, path)
    return path


def export_zy3_pt(path: str, ds, ids: Optional[Sequence[str]] = None,
                  with_masks: bool = True) -> str:
    """Write ZY-3 scenes as the reference's {id: {'true_color', 'mask'}}
    dict (prepare_cloud_traindata / testdata,
    dataloader/zy3_cloud_thumbnailv5_20240304.py:80-106); imgs
    [N, H, W, 3] are written [3, H, W]."""
    imgs = _host(ds["imgs"])
    ids = list(ids) if ids is not None else [
        f"{1700000000 + i}" for i in range(imgs.shape[0])]
    masks = _host(ds["labels"]) if with_masks and _has_labels(ds) else None
    out = {}
    for i, img_id in enumerate(ids):
        rec = {"true_color": imgs[i].permute(2, 0, 1).contiguous()}
        if masks is not None:
            rec["mask"] = masks[i].clone()
        out[img_id] = rec
    torch.save(out, path)
    return path


def export_nau_pt(path: str, ds, ids: Optional[Sequence[str]] = None) -> str:
    """Write radar rain frames as the reference's {name: {'img', 'label'}}
    dict (dataloader/nau_rain_20230523.py:12-38). The reference loader
    min-max normalizes at construction, so [0, 1] frames load unchanged."""
    imgs = _host(ds["imgs"])[..., 0]
    labels = _host(ds["labels"])
    ids = list(ids) if ids is not None else [
        f"nau_{i:03d}" for i in range(imgs.shape[0])]
    torch.save({name: {"img": imgs[i].clone(), "label": labels[i].clone()}
                for i, name in enumerate(ids)}, path)
    return path
