"""Correlated K-distributed sea clutter, generated on the device
(``onet_tpu/sim/kdist.py``).

The pipeline (Brekke, IJOE 2010, section IV, as in the reference):
  1. gamma-texture ACF R_T(x, y) = 1 + exp(-(x+y)/10) cos(pi y / 8) / v;
  2. Hermite-expansion coefficients of the Gaussian<->Gamma ACF relation
     from a white-noise sample (orders 2..0);
  3. per pixel, the larger-magnitude root of the quadratic for the
     Gaussian ACF (complex64, the principal branch of sqrt);
  4. FFT-colour a white field by sqrt(F[Gaussian ACF]);
  5. the memoryless nonlinear transform through the Gamma quantile,
     y = gammaincinv(v, ndtr(x)), inverted here by 20 damped Newton steps
     in float32 from a Wilson-Hilferty / left-tail seed;
  6. times correlated complex-Gaussian speckle with power-law PSD f^-0.6;
     the amplitude is the clutter.

Frames are batched over their leading axis; the FFTs run over the last two.
The reference's fast path crashes on a missing ``size`` argument; here, as
in the JAX package, the speckle generator always gets the field size.

``KDistSimulator.from_noise`` and ``frames_from_noise`` take the white-noise
fields as arguments, so that the arithmetic can be held against the JAX
package on its own noise.
"""

from __future__ import annotations

import math

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.sim.rayleigh import _check_gen, finish_frames


# ---------------------------------------------------------------------------
# the inverse regularized lower incomplete gamma
# ---------------------------------------------------------------------------

def gammaincinv(a: float, p: torch.Tensor, *, n_newton: int = 20):
    """Solve P(a, y) = p for y >= 0 in float32. ``a`` is a python float;
    ``p`` a float32 tensor in (0, 1)."""
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    z = torch.special.ndtri(p)
    c = 1.0 / (9.0 * a)
    y_wh = a * (1.0 - c + z * math.sqrt(c)) ** 3
    log_gamma_a = math.lgamma(a)
    # left-tail asymptotic: P(a, y) ~ y^a / (a Gamma(a)) for y -> 0
    y_small = torch.exp((torch.log(p) + math.log(a) + log_gamma_a) / a)
    y = torch.where(y_small < 0.6 * (a + 1.0), y_small,
                    torch.clamp(y_wh, min=1e-6))
    y = torch.clamp(y, min=1e-30)
    a_t = torch.tensor(a, dtype=p.dtype, device=p.device)
    for _ in range(n_newton):
        f = torch.special.gammainc(a_t, y) - p
        # P'(a, y) = y^(a-1) e^-y / Gamma(a)
        logpdf = (a - 1.0) * torch.log(y) - y - log_gamma_a
        step = f * torch.exp(-logpdf)
        step = torch.minimum(torch.maximum(step, -0.9 * y), 0.9 * y)
        y = torch.clamp(y - step, min=1e-30)
    return y


def mnlt(x: torch.Tensor, v: float) -> torch.Tensor:
    """Memoryless nonlinear transform, Gaussian -> Gamma(v) samples."""
    return gammaincinv(v, torch.special.ndtr(x))


# ---------------------------------------------------------------------------
# the ACF
# ---------------------------------------------------------------------------

def _hermite(x, n: int):
    if n == 0:
        return torch.ones_like(x)
    if n == 1:
        return 2 * x
    if n == 2:
        return 4 * x ** 2 - 2
    raise ValueError(n)


def acf_poly_coeffs(x: torch.Tensor, gamma_q: torch.Tensor) -> torch.Tensor:
    """Hermite-expansion coefficients [a2, a1, a0]."""
    coeffs = []
    for n in (2, 1, 0):
        factor = 1.0 / (math.pi * math.factorial(n) * 2 ** n)
        s = torch.sum(torch.exp(-x ** 2) * _hermite(x, n) * gamma_q)
        coeffs.append(factor * s ** 2)
    return torch.stack(coeffs)


def solve_gaussian_acf(gamma_acf: torch.Tensor,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """Per pixel, the larger-magnitude root of a2 y^2 + a1 y + (a0 - R_T)
    = 0 (np.roots' leading root in this regime); a complex discriminant
    takes the principal branch of sqrt."""
    a2, a1, a0 = coeffs[0], coeffs[1], coeffs[2]
    c = (a0 - gamma_acf).to(torch.complex64)
    disc = torch.sqrt((a1 ** 2).to(torch.complex64) - 4 * a2 * c)
    r1 = (-a1 + disc) / (2 * a2)
    r2 = (-a1 - disc) / (2 * a2)
    return torch.where(torch.abs(r1) >= torch.abs(r2), r1, r2)


def speckle_from_noise(gwn: torch.Tensor) -> torch.Tensor:
    """Complex speckle with power-law PSD f^-0.6 from white noise
    [..., size, size]."""
    size = gwn.shape[-1]
    fs = size / 10.0
    fx = torch.linspace(0.1, fs, size, device=gwn.device)
    dfs = torch.sqrt(fx[None, :] ** 2 + fx[:, None] ** 2)
    f_rc = dfs ** -0.6
    return torch.fft.ifft2(torch.fft.fft2(gwn)
                           * torch.sqrt(f_rc).to(torch.complex64))


def correlated_gaussian_expdecay(gen: torch.Generator, size: int):
    """Complex speckle field [size, size] drawn from ``gen``."""
    return speckle_from_noise(torch.randn((size, size), generator=gen,
                                          device=gen.device))


class KDistSimulator:
    """The solved Gaussian ACF of one frame size, built once (the
    reference's KField cache), and frames generated by the fast FFT path."""

    def __init__(self, gen: torch.Generator, size: int = 400,
                 gamma_shape: float = 5.0, device=None):
        dev = resolve_device(device)
        _check_gen(gen, dev)
        self._setup(torch.randn((size, size), generator=gen, device=dev),
                    gamma_shape)

    @classmethod
    def from_noise(cls, gwn: torch.Tensor, gamma_shape: float = 5.0):
        """The simulator built on the white-noise field ``gwn`` [size,
        size] float32."""
        sim = cls.__new__(cls)
        sim._setup(gwn, gamma_shape)
        return sim

    def _setup(self, gwn: torch.Tensor, gamma_shape: float):
        n = gwn.shape[-1]
        self.size = n
        self.v = v = float(gamma_shape)
        xs = torch.linspace(10.0, n, n, device=gwn.device)
        grid_sum = xs[None, :] + xs[:, None]      # XS + YS
        ys = xs[:, None]
        self.gamma_acf = 1.0 + torch.exp(-grid_sum / 10.0) * torch.cos(
            math.pi * ys / 8.0) / v
        coeffs = acf_poly_coeffs(gwn, mnlt(gwn, v))
        self.coeffs = coeffs / coeffs[-1]
        self.gaussian_acf = solve_gaussian_acf(self.gamma_acf, self.coeffs)
        self.f_acf_sqrt = torch.sqrt(torch.fft.fft2(self.gaussian_acf))

    def frames_from_noise(self, gwn: torch.Tensor, gwn_speckle: torch.Tensor):
        """K-distributed amplitude frames and their Gamma textures from two
        white-noise fields [N, size, size] (texture, speckle)."""
        gcn = torch.real(torch.fft.ifft2(torch.fft.fft2(gwn)
                                         * self.f_acf_sqrt))
        gan = mnlt(gcn, self.v)
        speckle = speckle_from_noise(gwn_speckle)
        return torch.abs(speckle * torch.sqrt(gan).to(torch.complex64)), gan

    def frame_from_acf(self, gen: torch.Generator, n_frames: int = 1):
        """``n_frames`` amplitude frames and their textures, [N, size,
        size] each, drawn from ``gen``."""
        shape = (n_frames, self.size, self.size)
        gwn = torch.randn(shape, generator=gen, device=gen.device)
        gwn_speckle = torch.randn(shape, generator=gen, device=gen.device)
        return self.frames_from_noise(gwn, gwn_speckle)


def kdist_frames(gen: torch.Generator, snr_db, *, n_frames: int,
                 size: int = 400, crop: int = 224, gamma_shape: float = 5.0,
                 n_targets: int = 20, swerling: int = 0,
                 sim: KDistSimulator = None, device=None):
    """K-clutter frames with Gaussian EOTs: ([N, crop, crop] frames in
    [0, 1], masks)."""
    dev = resolve_device(device)
    _check_gen(gen, dev)
    sim = sim or KDistSimulator(gen, size, gamma_shape, device=dev)
    bg, _ = sim.frame_from_acf(gen, n_frames)
    return finish_frames(bg.to(torch.float32), snr_db, gen, crop=crop,
                         n_targets=n_targets, swerling=swerling)
