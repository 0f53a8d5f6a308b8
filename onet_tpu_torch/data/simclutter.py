"""Simulated sea-clutter datasets (``onet_tpu/data/simclutter.py``).

Two sources, one schema {imgs [N, H, W, 1], labels [N, H, W], psnr [N]}:

* generation on the device (``sim/rayleigh.py``, ``sim/kdist.py``): no
  files, no host loop;
* the reference's saved ``.pt`` dicts ({bg}_imgs [N, 1, H, W],
  {bg}_labels [N, H, W], psnr list), for runs on the reference's data.

Both re-apply the reference loader's per-frame min-max normalization and
support its SNR-range filter and its 90/10 shuffled split, globally or per
SNR level (``equal_split``).
"""

from __future__ import annotations

from typing import Optional

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.data.arrays import ArrayDataset, train_test_split
from onet_tpu_torch.ops.normalize import minmax_per_frame
from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset


def load_simclutter_pt(path: str, device=None) -> ArrayDataset:
    """Load a reference-format ``.pt`` dict onto ``device`` (default: the
    card). Only tensors and plain containers are unpickled."""
    dev = resolve_device(device)
    d = torch.load(path, map_location="cpu", weights_only=True)
    img_key = next(k for k in d if k.endswith("_imgs"))
    lab_key = next(k for k in d if k.endswith("_labels"))
    psnr = d["psnr"]
    psnr = (psnr.to(torch.int32) if isinstance(psnr, torch.Tensor)
            else torch.tensor([int(v) for v in psnr], dtype=torch.int32))
    return ArrayDataset({
        "imgs": d[img_key].to(dev, torch.float32).permute(0, 2, 3, 1)
        .contiguous(),
        "labels": d[lab_key].to(dev, torch.float32),
        "psnr": psnr.to(dev),
    })


def filter_by_snr_range(ds: ArrayDataset, low: int, high: int) -> ArrayDataset:
    """Keep the frames with low <= psnr <= high, in order."""
    snr = ds["psnr"]
    return ds.select(torch.nonzero((snr >= low) & (snr <= high))[:, 0])


def simclutter_datasets(gen: torch.Generator, *, low_snr: int = 0,
                        high_snr: int = 2, train_frac: float = 0.9,
                        source: Optional[ArrayDataset] = None,
                        frames_per_level: int = 150, crop: int = 224,
                        bg: str = "rayleigh", equal_split: bool = False,
                        device=None):
    """(train, test) datasets of the simclutter workload, drawn from
    ``gen`` on ``device``.

    With no ``source`` the levels low_snr..high_snr are generated on the
    device; ``bg`` selects the clutter family ("rayleigh" or "k").
    ``equal_split=True`` splits 90/10 per SNR level and concatenates (the
    reference's equalized loader: every level in both splits at exactly
    ``train_frac``); the default is one global shuffled split."""
    dev = resolve_device(device)
    if source is None:
        levels = tuple(range(low_snr, high_snr + 1))
        ds = ArrayDataset(generate_rayleigh_dataset(
            gen, levels=levels, frames_per_level=frames_per_level, crop=crop,
            bg=bg, device=dev))
    else:
        ds = filter_by_snr_range(source, low_snr, high_snr)
    # the reference loader normalizes every frame again (idempotent for
    # generated frames)
    ds = ArrayDataset({k: minmax_per_frame(v.to(dev)) if k == "imgs"
                       else v.to(dev) for k, v in ds.data.items()})
    if not equal_split:
        return train_test_split(ds, gen, train_frac)
    trains, tests = [], []
    for lvl in sorted(set(ds["psnr"].tolist())):
        tr, te = train_test_split(filter_by_snr_range(ds, lvl, lvl), gen,
                                  train_frac)
        trains.append(tr)
        tests.append(te)

    def _cat(parts):
        return ArrayDataset({k: torch.cat([p[k] for p in parts])
                             for k in parts[0].data})

    return _cat(trains), _cat(tests)
