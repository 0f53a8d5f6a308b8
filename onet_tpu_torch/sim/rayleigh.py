"""Rayleigh-background Gaussian-EOT frames, generated on the device
(``onet_tpu/sim/rayleigh.py``).

* background ~ Rayleigh(scale=1) at 400x400;
* 20 Gaussian extended targets, Swerling 0, peak-SNR calibrated
  (``sim/targets.py``);
* whole-frame min-max normalization, then a centre crop to 224;
* one PSNR level of 150 frames in one batched call; the dataset stacks
  the levels in the saved-.pt schema {imgs, labels, psnr}.

Everything is drawn from the generator passed in, on the device asked for
(default: the card; raises without one).
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.ops.normalize import minmax_per_frame
from onet_tpu_torch.sim.targets import draw_targets, rayleigh_sample, render

FRAME_SIZE = 400
CROP_SIZE = 224
FRAMES_PER_LEVEL = 150
PSNR_LEVELS = tuple(range(0, 11))


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Crop the trailing two spatial dims to ``size`` (torchvision
    CenterCrop: offset = floor((dim - size) / 2))."""
    h, w = x.shape[-2], x.shape[-1]
    top = (h - size) // 2
    left = (w - size) // 2
    return x[..., top:top + size, left:left + size]


def _check_gen(gen: torch.Generator, dev: torch.device):
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, data on {dev}: draw "
                         "on the data's device")


def finish_frames(clutter, snr_db, gen, *, crop, n_targets, swerling):
    """Targets drawn from ``gen`` placed on clutter [N, S, S]; each frame
    min-max normalized, then centre-cropped. Returns (frames, masks)."""
    n, h, w = clutter.shape
    tg = draw_targets(gen, n, h, w, n_targets=n_targets, swerling=swerling)
    frames, masks = render(clutter, snr_db, tg)
    return (center_crop(minmax_per_frame(frames), crop),
            center_crop(masks, crop))


def rayleigh_frames(gen: torch.Generator, snr_db, *,
                    n_frames: int = FRAMES_PER_LEVEL,
                    frame_size: int = FRAME_SIZE, crop: int = CROP_SIZE,
                    n_targets: int = 20, swerling: int = 0, device=None):
    """One PSNR level: ([N, crop, crop] frames in [0, 1], masks)."""
    _check_gen(gen, resolve_device(device))
    bg = rayleigh_sample(gen, (n_frames, frame_size, frame_size))
    return finish_frames(bg, snr_db, gen, crop=crop, n_targets=n_targets,
                         swerling=swerling)


def generate_rayleigh_dataset(gen: torch.Generator, *, levels=PSNR_LEVELS,
                              frames_per_level: int = FRAMES_PER_LEVEL,
                              crop: int = CROP_SIZE, swerling: int = 0,
                              bg: str = "rayleigh", device=None):
    """The simclutter dataset: {imgs [N, crop, crop, 1], labels
    [N, crop, crop], psnr [N] int32}, on ``device``. ``bg`` selects the
    clutter family, as the reference's bg_type: "rayleigh" or "k"
    (correlated K-distributed clutter, ``sim/kdist.py``, its spectral ACF
    built once and shared across the levels)."""
    if bg not in ("rayleigh", "k"):
        raise ValueError(f"bg must be 'rayleigh' or 'k', not {bg!r}")
    dev = resolve_device(device)
    _check_gen(gen, dev)
    sim = None
    if bg == "k":
        from onet_tpu_torch.sim.kdist import KDistSimulator
        sim = KDistSimulator(gen, device=dev)
    imgs, labels, psnrs = [], [], []
    for lvl in levels:
        if bg == "k":
            from onet_tpu_torch.sim.kdist import kdist_frames
            f, m = kdist_frames(gen, float(lvl), n_frames=frames_per_level,
                                crop=crop, swerling=swerling, sim=sim,
                                device=dev)
        else:
            f, m = rayleigh_frames(gen, float(lvl), n_frames=frames_per_level,
                                   crop=crop, swerling=swerling, device=dev)
        imgs.append(f)
        labels.append(m)
        psnrs.append(torch.full((frames_per_level,), lvl, dtype=torch.int32,
                                device=dev))
    return {"imgs": torch.cat(imgs)[..., None],
            "labels": torch.cat(labels),
            "psnr": torch.cat(psnrs)}
