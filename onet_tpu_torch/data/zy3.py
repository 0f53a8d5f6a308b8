"""ZY-3 cloud-detection data (``onet_tpu/data/zy3.py``): for now only its
low-pass noise texture, which the NAU rain synthesizer also draws.

The JAX ``_smooth_noise(key, shape, cutoff)`` is split, as the simulators
are: ``smooth_noise_from`` filters given white noise deterministically (so
it is held exactly against the JAX package on JAX's own draws), and
``smooth_noise`` draws the noise from a ``torch.Generator``. The rest of
the module (the .pt loader, ``synthesize_zy3``) comes with the ZY-3
workload.
"""

from __future__ import annotations

import torch


def smooth_noise_from(noise: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Gaussian low-pass (in cycles/sample, ``cutoff`` its sigma) of white
    noise [..., H, W], each frame min-max normalized to [0, 1]."""
    h, w = noise.shape[-2:]
    f = torch.fft.fft2(noise.to(torch.float32))
    fy = torch.fft.fftfreq(h, device=noise.device)[:, None]
    fx = torch.fft.fftfreq(w, device=noise.device)[None, :]
    mask = torch.exp(-((fx ** 2 + fy ** 2) / (2 * cutoff ** 2)))
    s = torch.fft.ifft2(f * mask).real
    lo = torch.amin(s, dim=(-2, -1), keepdim=True)
    hi = torch.amax(s, dim=(-2, -1), keepdim=True)
    return (s - lo) / (hi - lo + 1e-12)


def smooth_noise(gen: torch.Generator, shape, cutoff: float) -> torch.Tensor:
    """Low-pass-filtered white noise in [0, 1] (cloud, terrain or rain
    texture) of ``shape`` [..., H, W], drawn on the generator's device."""
    noise = torch.randn(shape, generator=gen, device=gen.device)
    return smooth_noise_from(noise, cutoff)
