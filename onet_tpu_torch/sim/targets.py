"""Gaussian extended targets on clutter frames (``onet_tpu/sim/targets.py``).

Split in two, so that the arithmetic can be held exactly against the JAX
package whatever the random streams:

* ``draw_targets`` draws each frame's target parameters (centre, extent,
  orientation, Swerling amplitude) from a generator, on its device;
* ``render`` places them on a batch of clutter frames [N, H, W],
  deterministically, target after target in order (the JAX package's
  ``lax.scan``): a later target sees the clutter already raised by the
  earlier ones, as in the reference's in-place loop.

Every target is rendered over the full frame with a box mask. The
semantics are the reference's, quirks included:
* sigma = (extent/2 - 0.5)/2, clamped at 0.25; box half-width
  int(sigma*2.5 + 0.5);
* rotated anisotropic Gaussian, theta negated, peak 1; the theta drawn in
  degrees (U(0, 180)) is used as radians;
* centres floored, then clipped so the box stays inside the frame;
* amplitude sqrt(10^(snr/10) * erc) times the Swerling jitter, erc the
  clean frame's mean clutter energy;
* the foreground adds only where the template exceeds the current clutter;
* mask = kgauss > 1 - 2*std over the box, ORed across targets.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TINY = 1.1754944e-38     # smallest normal float32


class Targets(NamedTuple):
    """Per-frame target parameters, each [N, n_targets] float32."""
    cx: torch.Tensor
    cy: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    theta: torch.Tensor
    amp: torch.Tensor


def rayleigh_sample(gen: torch.Generator, shape) -> torch.Tensor:
    """Rayleigh(scale=1) by the inverse CDF on the generator's device. The
    uniform is clamped to [TINY, 1): ``torch.rand`` can return 0, whose log
    is -inf; the amplitude stays below sqrt(-2 ln TINY) ~= 13.2."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.sqrt(-2.0 * torch.log(torch.clamp(u, min=TINY)))


def draw_targets(gen: torch.Generator, n_frames: int, img_h: int,
                 img_w: int, *, n_targets: int = 20, swerling: int = 0,
                 center_std=(30.0, 24.0), extent_mean=(10.0, 18.0),
                 extent_std=(2.0, 2.0)) -> Targets:
    """Draw ``n_targets`` targets for each of ``n_frames`` frames."""
    shape = (n_frames, n_targets)

    def normal():
        return torch.randn(shape, generator=gen, device=gen.device)

    cx = img_w / 2 + center_std[0] * normal()
    cy = img_h / 2 + center_std[1] * normal()
    w = extent_mean[0] + extent_std[0] * normal()
    h = extent_mean[1] + extent_std[1] * normal()
    theta = torch.rand(shape, generator=gen, device=gen.device) * 180.0
    if swerling == 0:
        amp = torch.ones(shape, device=gen.device)
    elif swerling == 1:
        # mean of 1000 Rayleigh(scale = kcoef/sqrt(2)) draws, over kcoef
        amp = torch.mean(rayleigh_sample(gen, shape + (1000,))
                         / math.sqrt(2.0), dim=-1)
    elif swerling == 3:
        df = 4.0
        scale = 1.0 / math.sqrt(df * 2 + df ** 2)
        conc = torch.full(shape + (1000,), df / 2.0, device=gen.device)
        amp = torch.mean(scale * 2.0 * torch._standard_gamma(
            conc, generator=gen), dim=-1)
    else:
        raise ValueError(f"unsupported swerling type {swerling}")
    return Targets(cx, cy, w, h, theta, amp)


def _rotated_gauss_coeffs(sigma_x, sigma_y, theta):
    th = -theta
    a = torch.cos(th) ** 2 / (2 * sigma_x ** 2) + \
        torch.sin(th) ** 2 / (2 * sigma_y ** 2)
    b = -torch.sin(2 * th) / (4 * sigma_x ** 2) + \
        torch.sin(2 * th) / (4 * sigma_y ** 2)
    c = torch.sin(th) ** 2 / (2 * sigma_x ** 2) + \
        torch.cos(th) ** 2 / (2 * sigma_y ** 2)
    return a, b, c


def render(clutter: torch.Tensor, snr_db, targets: Targets):
    """Place ``targets`` on clutter frames [N, H, W] float32 at peak SNR
    ``snr_db``. Returns (frames [N, H, W], masks [N, H, W] float32)."""
    n, img_h, img_w = clutter.shape
    dev = clutter.device
    rows = torch.arange(img_h, dtype=torch.int32, device=dev).view(1, -1, 1)
    cols = torch.arange(img_w, dtype=torch.int32, device=dev).view(1, 1, -1)
    erc = torch.mean(torch.square(clutter), dim=(1, 2))
    snr_lin = torch.pow(10.0, torch.as_tensor(snr_db, dtype=torch.float32,
                                              device=dev) / 10.0)
    bg = clutter
    mask = torch.zeros(clutter.shape, dtype=torch.bool, device=dev)
    for t in range(targets.cx.shape[1]):
        cx, cy, w, h, theta, amp = (a[:, t] for a in targets)
        # a tail draw of w or h near 1 gives sigma -> 0, whose infinite
        # coefficient times the zero centre offset is NaN
        sigma_x = torch.clamp((w / 2 - 0.5) / 2, min=0.25)
        sigma_y = torch.clamp((h / 2 - 0.5) / 2, min=0.25)
        wr = torch.floor(sigma_x * 2.5 + 0.5).to(torch.int32)
        hr = torch.floor(sigma_y * 2.5 + 0.5).to(torch.int32)
        cxi = torch.clamp(torch.floor(cx).to(torch.int32), wr,
                          img_w - wr - 1)
        cyi = torch.clamp(torch.floor(cy).to(torch.int32), hr,
                          img_h - hr - 1)
        dx = cols - cxi.view(-1, 1, 1)
        dy = rows - cyi.view(-1, 1, 1)
        kx, ky = dx.to(torch.float32), dy.to(torch.float32)
        inbox = (dx.abs() <= wr.view(-1, 1, 1)) & \
            (dy.abs() <= hr.view(-1, 1, 1))
        a, b, c = (k.view(-1, 1, 1) for k in
                   _rotated_gauss_coeffs(sigma_x, sigma_y, theta))
        kgauss = torch.exp(-(a * kx ** 2 + 2 * b * kx * ky + c * ky ** 2))
        kgauss = torch.where(inbox, kgauss, 0.0)
        box_n = ((2 * wr + 1) * (2 * hr + 1)).to(torch.float32)
        kmean = torch.sum(kgauss, dim=(1, 2)) / box_n
        kstd = torch.sqrt(torch.clamp(
            torch.sum(kgauss ** 2, dim=(1, 2)) / box_n - kmean ** 2, min=0.0))
        kcoef = torch.sqrt(snr_lin * erc) * amp      # peak-SNR calibration
        template = kgauss * kcoef.view(-1, 1, 1)
        bg = bg + torch.where(inbox & (template > bg), template, 0.0)
        # the unnormalized peak is 1
        mask = mask | (inbox & (kgauss > (1.0 - 2.0 * kstd).view(-1, 1, 1)))
    return bg, mask.to(torch.float32)
