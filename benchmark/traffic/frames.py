"""Frozen frame generator: Rayleigh clutter with Gaussian extended
targets, the simulated-clutter data the Onet is trained and served on.

A plain copy of the port's generator (``sim/targets.py`` and
``sim/rayleigh.py``), kept here so that a change to the program cannot
change the benchmark's inputs: background ~ Rayleigh(scale 1) by the
inverse CDF; 20 Swerling-0 targets a frame, each a rotated anisotropic
Gaussian (theta drawn in degrees and used as radians, as the source
does) added where it exceeds the clutter, at a peak SNR set from the
frame's mean clutter energy; each frame min-max normalized. Frames are
drawn at the size they are served (no crop). The PSNR levels are the
same set for every seed, spread evenly over [lo, hi] dB, in an order the
seed draws.
"""

from __future__ import annotations


import numpy as np
import torch

TINY = 1.1754944e-38
EPS = float(np.spacing(1.0))


def psnr_levels(n: int, lo: float, hi: float, seed: int) -> np.ndarray:
    """n levels at the midpoints of n equal steps of [lo, hi], permuted
    by the seed."""
    lv = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return np.random.default_rng([seed, 1]).permutation(lv).astype(
        np.float32)


def _rayleigh(gen, shape, device):
    u = torch.rand(shape, generator=gen, device=device)
    return torch.sqrt(-2.0 * torch.log(torch.clamp(u, min=TINY)))


def _coeffs(sx, sy, theta):
    th = -theta
    a = torch.cos(th) ** 2 / (2 * sx ** 2) + torch.sin(th) ** 2 / (2 * sy ** 2)
    b = (-torch.sin(2 * th) / (4 * sx ** 2)
         + torch.sin(2 * th) / (4 * sy ** 2))
    c = torch.sin(th) ** 2 / (2 * sx ** 2) + torch.cos(th) ** 2 / (2 * sy ** 2)
    return a, b, c


def render(clutter, snr_db, gen, n_targets: int = 20):
    """Targets on clutter [N, H, W]; ``snr_db`` [N]. Returns frames."""
    n, hh, ww = clutter.shape
    dev = clutter.device
    shape = (n, n_targets)
    nrm = lambda: torch.randn(shape, generator=gen, device=dev)  # noqa
    cx = ww / 2 + 30.0 * nrm()
    cy = hh / 2 + 24.0 * nrm()
    tw = 10.0 + 2.0 * nrm()
    th_ = 18.0 + 2.0 * nrm()
    theta = torch.rand(shape, generator=gen, device=dev) * 180.0
    rows = torch.arange(hh, dtype=torch.int32, device=dev).view(1, -1, 1)
    cols = torch.arange(ww, dtype=torch.int32, device=dev).view(1, 1, -1)
    erc = torch.mean(clutter * clutter, dim=(1, 2))
    snr = torch.pow(10.0, snr_db.to(dev) / 10.0)
    kcoef = torch.sqrt(snr * erc)
    bg = clutter
    for t in range(n_targets):
        sx = torch.clamp((tw[:, t] / 2 - 0.5) / 2, min=0.25)
        sy = torch.clamp((th_[:, t] / 2 - 0.5) / 2, min=0.25)
        wr = torch.floor(sx * 2.5 + 0.5).to(torch.int32)
        hr = torch.floor(sy * 2.5 + 0.5).to(torch.int32)
        cxi = torch.clamp(torch.floor(cx[:, t]).to(torch.int32), wr,
                          ww - wr - 1)
        cyi = torch.clamp(torch.floor(cy[:, t]).to(torch.int32), hr,
                          hh - hr - 1)
        dx = cols - cxi.view(-1, 1, 1)
        dy = rows - cyi.view(-1, 1, 1)
        kx, ky = dx.float(), dy.float()
        inbox = (dx.abs() <= wr.view(-1, 1, 1)) & (dy.abs()
                                                   <= hr.view(-1, 1, 1))
        a, b, c = (k.view(-1, 1, 1) for k in _coeffs(sx, sy, theta[:, t]))
        kg = torch.exp(-(a * kx * kx + 2 * b * kx * ky + c * ky * ky))
        tmpl = torch.where(inbox, kg, 0.0) * kcoef.view(-1, 1, 1)
        bg = bg + torch.where(inbox & (tmpl > bg), tmpl, 0.0)
    return bg


def minmax(x):
    lo = torch.amin(x, dim=(1, 2), keepdim=True)
    hi = torch.amax(x, dim=(1, 2), keepdim=True)
    return (x - lo) / (hi - lo + EPS)


def make_pool(seed: int, n: int, hw, *, psnr=(0.0, 10.0), device,
              chunk: int = 64) -> torch.Tensor:
    """n frames [n, H, W, 1] float32 in [0, 1] on ``device``, drawn from
    ``seed`` on that device, ``chunk`` frames a call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed64(seed, 2))
    levels = torch.from_numpy(psnr_levels(n, psnr[0], psnr[1], seed))
    out = torch.empty((n, hw[0], hw[1], 1), dtype=torch.float32,
                      device=device)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        bg = _rayleigh(gen, (m, hw[0], hw[1]), device)
        out[lo:lo + m, ..., 0] = minmax(render(bg, levels[lo:lo + m], gen))
    return out


def _seed64(seed: int, stream: int) -> int:
    """A 63-bit generator seed derived from (seed, stream)."""
    s = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for (seed, stream): orders and samples."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])
