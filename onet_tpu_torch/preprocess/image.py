"""Image preprocessing (``onet_tpu/preprocess/image.py``): histogram
equalization, contrast enhancement, the Resize/CenterCrop thumbnail and
the nine ZY-3 preprocessing options.

* ``equalize_uint8``: PIL ImageOps.equalize's integer LUT, per channel;
* ``contrast_enhance``: PIL ImageEnhance.Contrast(0.5), a blend with solid
  gray at the rounded mean of the L channel;
* ``thumbnail_rgb``: Resize(smaller edge 300, bilinear, antialiased) then
  CenterCrop(224);
* ``apply_pre_option``: the nine options of the reference's
  make_thrumnail_image.

Every function takes uint8 tensors [H, W, 3] or a batch [N, H, W, 3] on
any device and computes there; the LUT stages are exact integer
arithmetic. The resize is ``F.interpolate(antialias=True)`` where the JAX
package calls ``jax.image.resize(antialias=True)``: the two triangle
filters round apart in the last bits, which moves a rounded uint8 by one
level on a small share of pixels (measured in tests/test_torch_zy3.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onet_tpu_torch.preprocess.haze import dehaze, div

PRE_OPTIONS = (
    "raw_rgb",
    "histeq_rgb", "contrast_enhance", "haze_enhance", "haze_remove",
    "histeq_haze_enhance", "histeq_haze_remove",
    "contrast_enhance_haze_enhance", "contrast_enhance_haze_remove",
)


def _batched(fn):
    """Apply ``fn`` (written for [N, H, W, C]) to one [H, W, C] frame too."""
    def wrapped(img, *a, **kw):
        if img.ndim == 3:
            return fn(img[None], *a, **kw)[0]
        return fn(img, *a, **kw)
    wrapped.__name__, wrapped.__doc__ = fn.__name__, fn.__doc__
    return wrapped


@_batched
def equalize_uint8(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize per channel of each uint8 frame: lut[i] =
    (step // 2 + #pixels below level i) // step, step = (pixels - count of
    the top occupied level) // 255; a channel with one occupied level or a
    zero step is left as it is."""
    n, h, w, c = img.shape
    bands = img.permute(0, 3, 1, 2).reshape(n * c, h * w).to(torch.int64)
    hist = torch.zeros((n * c, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, bands, torch.ones_like(bands))
    occupied = hist > 0
    top = 255 - torch.argmax(occupied.flip(1).to(torch.uint8), dim=1)
    step = (h * w - hist.gather(1, top[:, None])) // 255       # [NC, 1]
    below = torch.cumsum(hist, dim=1) - hist
    lut = torch.clamp((step // 2 + below) // torch.clamp_min(step, 1), 0, 255)
    keep = (occupied.sum(1, keepdim=True) <= 1) | (step == 0)
    out = torch.where(keep, bands, lut.gather(1, bands))
    return out.to(torch.uint8).reshape(n, c, h, w).permute(0, 2, 3, 1)


@_batched
def contrast_enhance(img: torch.Tensor, factor: float = 0.5) -> torch.Tensor:
    """PIL ImageEnhance.Contrast on uint8 RGB frames: blend with gray at
    int(mean(uint8(L)) + 0.5), L = (299 R + 587 G + 114 B) / 1000, each
    blended value rounded half up by truncation of + 0.5."""
    f = img.to(torch.int64)
    lum = (f[..., 0] * 299 + f[..., 1] * 587 + f[..., 2] * 114) // 1000
    # int(sum / n + 0.5) in integers: no quotient of these sizes rounds
    # onto a half, so this is PIL's float result on every device
    n = lum[0].numel()
    mean = ((2 * lum.sum(dim=(1, 2)) + n) // (2 * n)).double()
    blended = (img.double() * factor
               + mean[:, None, None, None] * (1.0 - factor))
    return torch.clamp(blended + 0.5, 0, 255).to(torch.uint8)


def _resized_hw(h: int, w: int, target: int):
    if h <= w:
        return target, max(1, round(w * target / h))
    return max(1, round(h * target / w)), target


@_batched
def rgb_resize_smaller_edge(img: torch.Tensor, target: int) -> torch.Tensor:
    """Bilinear, antialiased resize of uint8 frames so the smaller edge is
    ``target`` (torchvision Resize(n)), rounded back to uint8."""
    nh, nw = _resized_hw(img.shape[1], img.shape[2], target)
    x = img.permute(0, 3, 1, 2).to(torch.float32)
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True,
                      align_corners=False)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8).permute(
        0, 2, 3, 1)


def center_crop_hw(img: torch.Tensor, size: int) -> torch.Tensor:
    """The centered size x size window of [..., H, W, C]."""
    h, w = img.shape[-3:-1]
    top, left = (h - size) // 2, (w - size) // 2
    return img[..., top:top + size, left:left + size, :]


def thumbnail_rgb(img: torch.Tensor, *, resize_to: int = 300,
                  crop: int = 224) -> torch.Tensor:
    return center_crop_hw(rgb_resize_smaller_edge(img, resize_to), crop)


def _unit(u8: torch.Tensor) -> torch.Tensor:
    return div(u8.to(torch.float32), 255.0)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """float in [0, 1] -> uint8 by truncation of x * 255 (numpy's astype)."""
    return (x * 255).to(torch.uint8)


def apply_pre_option(u8: torch.Tensor, option: str) -> torch.Tensor:
    """One of the nine preprocessing options on uint8 thumbnails [H, W, 3]
    or [N, H, W, 3] -> float32 in [0, 1] (the reference's ToTensor
    output)."""
    if option not in PRE_OPTIONS:
        raise ValueError(f"unknown preprocessing option {option!r}")
    if option == "raw_rgb":
        return _unit(u8)
    if option == "histeq_rgb":
        return _unit(equalize_uint8(u8))
    if option == "contrast_enhance":
        return _unit(contrast_enhance(u8))
    base = u8
    if option.startswith("histeq_"):
        base = equalize_uint8(u8)
    elif option.startswith("contrast_enhance_"):
        base = contrast_enhance(u8)
    i = _unit(base)
    j, k = dehaze(i)
    if option.endswith("haze_remove"):
        return _unit(_to_u8(torch.clamp(j, 0, 1)))
    gain = 1.0 if option == "haze_enhance" else 1.7
    return _unit(_to_u8(torch.clamp(i + (gain * k)[..., None], 0, 1)))
