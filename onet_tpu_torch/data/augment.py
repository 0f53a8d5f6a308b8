"""Device-side stochastic augmentation (``onet_tpu/data/augment.py``): the
ZY-3 compose, its joint image+mask form, and the simclutter pixel compose.

The ZY-3 compose (the reference's unsupervised ZY-3 train augmentation,
dataloader/zy3_cloud_thumbnailv5_20240304.py:44-79) on each [H, W, C]
frame of a batch: one of {hflip, vflip, transpose} p=0.8; rotate(-90..90
deg) p=0.2; RandomSnow p=0.1; one of {elastic, grid distortion, gaussian
blur} p=0.1; brightness/contrast p=0.1. The joint form (the supervised
datasets, :124-216) moves the mask with the geometric steps (nearest
sampling) and leaves it out of the photometric ones; it has no distortion
step. Geometric warps sample bilinearly by gather with zero fill, as the
JAX package does (``F.grid_sample`` is not used: its coordinate
convention and border handling differ).

The simclutter compose (dataloader/simbg4onet_20230209.py:30-59, train
only; its published config runs with augmentation off), on one [H, W, 1]
frame in [0, 1]: a uint8 round trip, then Defocus(p=.1), CLAHE(p=.1),
Equalize(p=.1), PixelDropout(p=.1), GaussianBlur(p=.1),
BrightnessContrast(p=.2), PixelDropout(p=.2), CoarseDropout(p=.2),
HFlip(p=.2), then the reference's re-normalization quirk: the augmented
max (0..255) minus the ORIGINAL image's min (0..1) in the denominator.

Every random choice is drawn first (``draw_zy3_augment``,
``draw_pixel_augment``, on the generator's device); applying them
(``apply_zy3_augment``, ``apply_pixel_augment`` and the helpers, each
deterministic given its drawn parameters) computes every step for the
whole batch and selects per frame with ``torch.where``, as the JAX package
does, so no choice waits for the host.
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
    be a tensor (``gaussian_blur_frames`` of one frame)."""
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=img.device)
    return gaussian_blur_frames(img[None], sig.reshape(1),
                                radius=radius)[0]


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


# ---------------------------------------------------------------------------
# the ZY-3 compose, batched: images [B, H, W, C], masks [B, H, W]
# ---------------------------------------------------------------------------

P_GEO, P_ROT, P_SNOW, P_DISTORT, P_BC = 0.8, 0.2, 0.1, 0.1, 0.1
SNOW_POINT, SNOW_BRIGHTNESS = (0.1, 0.2), 2.5
ELASTIC_ALPHA, ELASTIC_SIGMA = 120.0, 6.0
GRID_STEPS, GRID_LIMIT = 5, 0.3
BLUR_SIGMA = (0.5, 2.0)
B_LIMIT, C_LIMIT = (0.04, 0.38), (-0.19, 0.35)


def _per_frame(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-frame value [B] shaped to broadcast against ``like``."""
    return v.reshape(-1, *([1] * (like.ndim - 1)))


def _pick(take: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(_per_frame(take, a), a, b)


def _bilinear_sample(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    """img [B, H, W, C]; yy, xx [B, h, w] float sample coordinates ->
    [B, h, w, C]. Each of the four neighbours is gathered at its index
    clipped into the frame and zeroed when it lies outside."""
    b, h, w, c = img.shape
    y0, x0 = torch.floor(yy), torch.floor(xx)
    ty, tx = (yy - y0)[..., None], (xx - x0)[..., None]
    flat = img.reshape(b, h * w, c)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(*yi.shape, c)
        return torch.where(inside[..., None], v, 0.0)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return ((v00 * (1 - tx) + v01 * tx) * (1 - ty)
            + (v10 * (1 - tx) + v11 * tx) * ty)


def _nearest_sample(mask: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    """mask [B, H, W]; nearest-neighbour sampling (round half to even, as
    ``jnp.round``), zero outside the frame."""
    b, h, w = mask.shape
    yi, xi = torch.round(yy), torch.round(xx)
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
    xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
    v = torch.gather(mask.reshape(b, h * w), 1,
                     (yc * w + xc).reshape(b, -1)).reshape(yi.shape)
    return torch.where(inside, v, 0.0)


def _grid(b: int, h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(h, w)[None].expand(b, h, w), \
        xx.expand(h, w)[None].expand(b, h, w)


def rotation_coords(angle: torch.Tensor, h: int, w: int):
    """Source coordinates (sy, sx), each [B, H, W], of a rotation by
    ``angle`` [B] (radians) about the frame's center."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _grid(angle.shape[0], h, w, angle.device)
    yy, xx = yy - cy, xx - cx
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    return cos * yy - sin * xx + cy, sin * yy + cos * xx + cx


def rotate(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each frame of [B, H, W, C] by its ``angle`` about the
    center, bilinear, zero fill."""
    return _bilinear_sample(img, *rotation_coords(angle, *img.shape[1:3]))


def geometric(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Per frame of [B, H, W(, C)]: sel 0 hflip, 1 vflip, 2 transpose
    (square frames only, as the JAX package's switch needs)."""
    if x.shape[1] != x.shape[2]:
        raise ValueError(f"the transpose branch needs square frames, got "
                         f"{tuple(x.shape)}")
    s = _per_frame(sel, x)
    return torch.where(s == 0, x.flip(2),
                       torch.where(s == 1, x.flip(1), x.transpose(1, 2)))


def gaussian_blur_frames(img: torch.Tensor, sigma: torch.Tensor, *,
                         radius: int = 4) -> torch.Tensor:
    """Separable Gaussian blur of each frame of [B, H, W, C] with its own
    ``sigma`` [B], zero padding (``gaussian_blur`` per frame)."""
    b, h, w, c = img.shape
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=img.device)
    k = torch.exp(-0.5 * (xs / torch.clamp(sigma, min=1e-3)[:, None]) ** 2)
    k = (k / torch.sum(k, dim=1, keepdim=True)).repeat_interleave(c, 0)
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.conv2d(x, k[:, None, :, None], padding=(radius, 0), groups=b * c)
    x = F.conv2d(x, k[:, None, None, :], padding=(0, radius), groups=b * c)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def random_snow(img: torch.Tensor, q: torch.Tensor, *,
                brightness: float = SNOW_BRIGHTNESS) -> torch.Tensor:
    """Brighten each frame above its drawn ``q`` [B] quantile (the whole
    frame's values, ``jnp.quantile``'s interpolation): RandomSnow's
    snow-like highlights."""
    from onet_tpu_torch.metrics.roc import quantile

    thresh = _per_frame(quantile(img.reshape(img.shape[0], -1), q), img)
    return torch.clamp(torch.where(img > thresh, img * brightness, img),
                       0.0, 1.0)


def pixel_dropout(img: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the pixels (every channel) where ``keep`` [B, H, W] is false."""
    return img * keep[..., None]


def elastic_warp(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, *,
                 alpha: float = ELASTIC_ALPHA,
                 sigma: float = ELASTIC_SIGMA) -> torch.Tensor:
    """ElasticTransform: the drawn unit displacement fields ``dx``, ``dy``
    [B, H, W] (uniform in [-1, 1)) Gaussian-smoothed with ``sigma``,
    normalized per frame to unit largest amplitude, scaled by alpha / 10
    pixels; bilinear resampling."""
    b, h, w, _ = img.shape
    sig = torch.full((b,), sigma, dtype=torch.float32, device=img.device)
    r = int(2 * sigma)
    dx = gaussian_blur_frames(dx[..., None], sig, radius=r)[..., 0]
    dy = gaussian_blur_frames(dy[..., None], sig, radius=r)[..., 0]
    norm = torch.maximum(torch.amax(dx.abs(), dim=(1, 2)),
                         torch.amax(dy.abs(), dim=(1, 2))) + 1e-6
    norm = norm[:, None, None]
    dx = dx / norm * (alpha / 10.0)
    dy = dy / norm * (alpha / 10.0)
    yy, xx = _grid(b, h, w, img.device)
    return _bilinear_sample(img, yy + dy, xx + dx)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp(x, xp[b], fp)`` for each row b of ``xp`` [B, K]; ``x``
    [S] and ``fp`` [K] shared. The same index clip, zero-width guard and
    constant extension; the multiply-add contracted as XLA compiles it."""
    from onet_tpu_torch.metrics.roc import _fma

    k = xp.shape[1]
    xb = x[None].expand(xp.shape[0], -1).contiguous()
    i = torch.clamp(torch.searchsorted(xp.contiguous(), xb, right=True),
                    1, k - 1)
    xp_lo, xp_hi = xp.gather(1, i - 1), xp.gather(1, i)
    f_lo, f_hi = fp[i - 1], fp[i]
    dx = xp_hi - xp_lo
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f_lo, _fma((xb - xp_lo) / torch.where(
        dx0, torch.ones_like(dx), dx), f_hi - f_lo, f_lo))
    f = torch.where(xb < xp[:, :1], fp[0], f)
    return torch.where(xb > xp[:, -1:], fp[-1], f)


def _axis_map(steps: torch.Tensor, size: int) -> torch.Tensor:
    """[B, size] source coordinates along one axis from the per-cell
    stretch factors ``steps`` [B, K]: the piecewise-linear inverse of the
    stretched cell boundaries onto the uniform destination grid."""
    from onet_tpu_torch.metrics.roc import linspace_f32

    b, k = steps.shape
    cell = size / k
    stretched = torch.cat([torch.zeros((b, 1), device=steps.device),
                           torch.cumsum(steps * cell, dim=1)], dim=1)
    stretched = stretched / stretched[:, -1:] * (size - 1)
    dst = linspace_f32(0.0, size - 1, k + 1, device=steps.device)
    coords = torch.arange(size, dtype=torch.float32, device=steps.device)
    return _interp(coords, stretched, dst)


def grid_distortion(img: torch.Tensor, steps_y: torch.Tensor,
                    steps_x: torch.Tensor) -> torch.Tensor:
    """GridDistortion: per-cell stretch factors (1 + uniform(-limit,
    limit), [B, K] per axis) integrated into a monotone coordinate map;
    bilinear resampling."""
    b, h, w, _ = img.shape
    sy = _axis_map(steps_y, h)[:, :, None].expand(b, h, w)
    sx = _axis_map(steps_x, w)[:, None, :].expand(b, h, w)
    return _bilinear_sample(img, sy, sx)


def draw_zy3_augment(gen: torch.Generator, b: int, h: int, w: int) -> dict:
    """Every random choice of a batch's ZY-3 compose, drawn from ``gen``
    on its device: per frame, which steps run and their parameters (the
    geometric branch, the angle, the snow quantile, the distortion branch,
    its elastic fields, grid steps and blur sigma, the brightness/contrast
    pair). The compose has no dropout step (``pixel_dropout`` is a
    separate op)."""
    dev = gen.device

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def branch():
        return torch.randint(0, 3, (b,), generator=gen, device=dev)

    return dict(
        take_geo=u(b) < P_GEO, geo=branch(),
        take_rot=u(b) < P_ROT, angle=u(b, lo=-np.pi / 2, hi=np.pi / 2),
        take_snow=u(b) < P_SNOW,
        snow_q=u(b, lo=1 - SNOW_POINT[1], hi=1 - SNOW_POINT[0]),
        take_distort=u(b) < P_DISTORT, distort=branch(),
        sigma=u(b, lo=BLUR_SIGMA[0], hi=BLUR_SIGMA[1]),
        dx=u(b, h, w, lo=-1.0), dy=u(b, h, w, lo=-1.0),
        grid_y=1.0 + u(b, GRID_STEPS, lo=-GRID_LIMIT, hi=GRID_LIMIT),
        grid_x=1.0 + u(b, GRID_STEPS, lo=-GRID_LIMIT, hi=GRID_LIMIT),
        take_bc=u(b) < P_BC, beta=u(b, lo=B_LIMIT[0], hi=B_LIMIT[1]),
        alpha=1.0 + u(b, lo=C_LIMIT[0], hi=C_LIMIT[1]))


def distort(img: torch.Tensor, d: dict) -> torch.Tensor:
    """The distortion family per frame: branch 0 elastic, 1 grid, 2
    gaussian blur."""
    s = _per_frame(d["distort"], img)
    return torch.where(
        s == 0, elastic_warp(img, d["dx"], d["dy"]),
        torch.where(s == 1, grid_distortion(img, d["grid_y"], d["grid_x"]),
                    gaussian_blur_frames(img, d["sigma"])))


def apply_zy3_augment(imgs: torch.Tensor, d: dict,
                      masks: torch.Tensor = None):
    """The ZY-3 compose on [B, H, W, C] in [0, 1] with the choices ``d``
    of ``draw_zy3_augment``. With ``masks`` [B, H, W] the joint form:
    returns (imgs, masks), the masks moved by the flip/transpose and the
    rotation (nearest) and untouched otherwise, no distortion step."""
    img = _pick(d["take_geo"], geometric(imgs, d["geo"]), imgs)
    sy, sx = rotation_coords(d["angle"], *imgs.shape[1:3])
    img = _pick(d["take_rot"], _bilinear_sample(img, sy, sx), img)
    if masks is not None:
        masks = _pick(d["take_geo"], geometric(masks, d["geo"]), masks)
        masks = _pick(d["take_rot"], _nearest_sample(masks, sy, sx), masks)
    img = _pick(d["take_snow"], random_snow(img, d["snow_q"]), img)
    if masks is None:
        img = _pick(d["take_distort"], distort(img, d), img)
    img = _pick(d["take_bc"], brightness_contrast(
        img, _per_frame(d["alpha"], img), _per_frame(d["beta"], img)), img)
    return img if masks is None else (img, masks)


def augment_batch(gen: torch.Generator, imgs: torch.Tensor) -> torch.Tensor:
    """The ZY-3 compose on [B, H, W, C], its choices drawn from ``gen``."""
    return apply_zy3_augment(imgs, draw_zy3_augment(gen, *imgs.shape[:3]))


def augment_batch_with_masks(gen: torch.Generator, imgs: torch.Tensor,
                             masks: torch.Tensor):
    """The joint compose on (imgs [B, H, W, C], masks [B, H, W]), its
    choices drawn from ``gen``."""
    return apply_zy3_augment(imgs, draw_zy3_augment(gen, *imgs.shape[:3]),
                             masks)
