"""The simclutter pixel augmentation (``onet_tpu/data/augment.py``, the
part the simclutter driver calls with ``config.aug``; the geometric and
ZY-3 composes are not ported yet).

The reference's simclutter compose (dataloader/simbg4onet_20230209.py:
30-59, train only; its published config runs with augmentation off), on
one [H, W, 1] frame in [0, 1]: a uint8 round trip, then Defocus(p=.1),
CLAHE(p=.1), Equalize(p=.1), PixelDropout(p=.1), GaussianBlur(p=.1),
BrightnessContrast(p=.2), PixelDropout(p=.2), CoarseDropout(p=.2),
HFlip(p=.2), then the reference's re-normalization quirk: the augmented
max (0..255) minus the ORIGINAL image's min (0..1) in the denominator.

Every random choice is drawn first (``draw_pixel_augment``, on the
generator's device); applying them (``apply_pixel_augment`` and the
helpers, each deterministic given its drawn parameters) computes every
branch and selects with ``torch.where``, as the JAX package does, so no
choice waits for the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SPACING1 = float(np.spacing(1.0))
# the probabilities of the compose's nine steps, in order
_P = (0.1, 0.1, 0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 0.2)
HOLES, HOLE_HW = 8, 8          # CoarseDropout's defaults
DEFOCUS_RADIUS = (3, 10)


def gaussian_blur(img: torch.Tensor, sigma, *, radius: int = 4):
    """Separable Gaussian blur of [H, W, C], zero padding; ``sigma`` may
    be a tensor."""
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=img.device)
    k = torch.exp(-0.5 * (xs / torch.clamp(torch.as_tensor(
        sigma, dtype=torch.float32, device=img.device), min=1e-3)) ** 2)
    k = k / torch.sum(k)
    x = img.permute(2, 0, 1)[:, None]             # [C, 1, H, W]
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius))
    return x[:, 0].permute(1, 2, 0)


def brightness_contrast(img: torch.Tensor, alpha, beta) -> torch.Tensor:
    """clip(img * alpha + beta, 0, 1) with the drawn contrast ``alpha``
    and brightness ``beta``."""
    return torch.clamp(img * alpha + beta, 0.0, 1.0)


def equalize_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist on [H, W] uint8-valued floats:
    lut[i] = round((cdf(i) - cdf_min) / (N - cdf_min) * 255)."""
    v = img_u8.to(torch.int64)
    hist = torch.bincount(v.reshape(-1), minlength=256).to(torch.float32)
    cdf = torch.cumsum(hist, 0)
    cdf_min = torch.min(torch.where(hist > 0, cdf, torch.inf))
    denom = torch.clamp(cdf[-1] - cdf_min, min=1.0)
    lut = torch.clamp(torch.round((cdf - cdf_min) / denom * 255.0), 0, 255)
    return lut[v]


def clahe_u8(img_u8: torch.Tensor, *, tiles: int = 8,
             clip_limit: float = 4.0) -> torch.Tensor:
    """CLAHE (cv2.createCLAHE) on [H, W] uint8-valued floats; H and W must
    divide by ``tiles``. cv2's integer clip, its uniform redistribution of
    the excess and its residual bumps; tile LUTs blended bilinearly."""
    h, w = img_u8.shape
    th, tw = h // tiles, w // tiles
    v = img_u8.to(torch.int64)
    tiled = v.reshape(tiles, th, tiles, tw).permute(0, 2, 1, 3).reshape(
        tiles * tiles, th * tw)                                 # [T, P]
    hist = torch.zeros((tiles * tiles, 256), dtype=torch.float32,
                       device=v.device).scatter_add_(
        1, tiled, torch.ones(tiled.shape, dtype=torch.float32,
                             device=v.device))
    area = th * tw
    clip = max(int(clip_limit * area / 256), 1)                 # cv2 int clip
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=1,
                       keepdim=True).to(torch.int32)
    batchv = excess // 256
    residual = excess - batchv * 256
    hist = torch.clamp(hist, max=float(clip)) + batchv.to(torch.float32)
    # cv2's residual: +1 at bins 0, step, 2*step, ... (residual bins)
    idx = torch.arange(256, device=v.device)[None, :]
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    hist = hist + ((idx % step == 0) & (idx // step < residual)).to(
        torch.float32)
    cdf = torch.cumsum(hist, dim=1)
    luts = torch.clamp(torch.round(cdf * (255.0 / area)), 0, 255)
    luts = luts.reshape(tiles, tiles, 256)

    def coords(n, t):
        x = (torch.arange(n, dtype=torch.float32, device=v.device)
             + 0.5) / t - 0.5
        x0 = torch.clamp(torch.floor(x), 0, tiles - 1).to(torch.int64)
        return x0, torch.clamp(x0 + 1, 0, tiles - 1), \
            torch.clamp(x - x0, 0.0, 1.0)

    y0, y1, fy = coords(h, th)
    x0, x1, fx = coords(w, tw)
    fy, fx = fy[:, None], fx[None, :]

    def at(ty, tx):
        return luts[ty[:, None], tx[None, :], v]

    out = ((1 - fy) * (1 - fx) * at(y0, x0) + (1 - fy) * fx * at(y0, x1)
           + fy * (1 - fx) * at(y1, x0) + fy * fx * at(y1, x1))
    return torch.round(out)


def defocus_u8(img_u8: torch.Tensor, radius) -> torch.Tensor:
    """albumentations Defocus on [H, W] uint8-valued floats: a disc blur
    of the drawn integer ``radius``, as a SAME conv with a disc kernel of
    the largest radius masked to ``radius``."""
    rmax = DEFOCUS_RADIUS[1]
    yy = torch.arange(2 * rmax + 1, dtype=torch.float32,
                      device=img_u8.device) - rmax
    dist2 = yy[:, None] ** 2 + yy[None, :] ** 2
    r = torch.as_tensor(radius, device=img_u8.device).to(torch.float32)
    disc = (dist2 <= r ** 2).to(torch.float32)
    disc = disc / torch.sum(disc)
    out = F.conv2d(img_u8[None, None], disc[None, None], padding=rmax)[0, 0]
    return torch.round(torch.clamp(out, 0, 255))


def coarse_dropout_u8(img_u8: torch.Tensor, ys, xs) -> torch.Tensor:
    """albumentations CoarseDropout: HOLE_HW x HOLE_HW holes at the drawn
    top-left corners (``ys``, ``xs``), filled with 0."""
    h, w = img_u8.shape
    yy = torch.arange(h, device=img_u8.device)[:, None]
    xx = torch.arange(w, device=img_u8.device)[None, :]
    keep = torch.ones((h, w), dtype=torch.bool, device=img_u8.device)
    for i in range(ys.shape[0]):
        keep = keep & ~((yy >= ys[i]) & (yy < ys[i] + HOLE_HW)
                        & (xx >= xs[i]) & (xx < xs[i] + HOLE_HW))
    return img_u8 * keep


def draw_pixel_augment(gen: torch.Generator, h: int, w: int) -> dict:
    """Every random choice of one frame's compose, drawn from ``gen`` on
    its device: which of the nine steps run, and their parameters."""
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    return dict(
        take=u(len(_P)) < torch.tensor(_P, device=dev),
        radius=randint(DEFOCUS_RADIUS[0], DEFOCUS_RADIUS[1] + 1, ()),
        keep1=u(h, w) < 0.99,
        sigma=0.5 + 1.5 * u(),
        beta=0.04 + 0.34 * u(),
        alpha=1.0 + (-0.19 + 0.54 * u()),
        keep2=u(h, w) < 0.99,
        ys=randint(0, h - HOLE_HW + 1, (HOLES,)),
        xs=randint(0, w - HOLE_HW + 1, (HOLES,)))


def apply_pixel_augment(img: torch.Tensor, d: dict) -> torch.Tensor:
    """The compose on one [H, W, 1] frame in [0, 1] with the choices ``d``
    of ``draw_pixel_augment``."""
    take = d["take"]
    u8 = torch.round(torch.clamp(img[..., 0], 0, 1) * 255.0)
    steps = (
        lambda x: defocus_u8(x, d["radius"]),
        clahe_u8,
        equalize_u8,
        lambda x: x * d["keep1"],
        lambda x: torch.round(gaussian_blur(x[..., None], d["sigma"])[..., 0]),
        lambda x: brightness_contrast(x[..., None] / 255.0, d["alpha"],
                                      d["beta"])[..., 0] * 255.0,
        lambda x: x * d["keep2"],
        lambda x: coarse_dropout_u8(x, d["ys"], d["xs"]),
        lambda x: x.flip(1),
    )
    for i, step in enumerate(steps):
        u8 = torch.where(take[i], step(u8), u8)
    lo = torch.min(u8)
    # the reference's quirk (:59): the denominator mixes scales, the
    # augmented max (0..255) minus the ORIGINAL image's min (0..1):
    #   (aug - aug.min()) / (aug.max() - image.min() + np.spacing(1))
    denom = torch.max(u8) - torch.min(img[..., 0]) + _SPACING1
    return ((u8 - lo) / denom)[..., None]


def simclutter_pixel_augment_one(gen: torch.Generator,
                                 img: torch.Tensor) -> torch.Tensor:
    """The compose on one [H, W, 1] frame, its choices drawn from ``gen``."""
    return apply_pixel_augment(img, draw_pixel_augment(gen, *img.shape[:2]))


def simclutter_pixel_augment(gen: torch.Generator,
                             imgs: torch.Tensor) -> torch.Tensor:
    """The compose on each frame of [B, H, W, 1], drawn in frame order."""
    return torch.stack([simclutter_pixel_augment_one(gen, img)
                        for img in imgs])
