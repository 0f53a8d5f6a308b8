"""NAU marine-radar rain-clutter data (``onet_tpu/data/nau.py``).

The reference's loader reads a .pt dict {name: {'img': [200, 200],
'label': [200, 200]}} and min-max normalizes each image; here the same onto
the device, with the id list kept on the host. For runs without the real
radar file, a synthesizer: rain masses (smooth noise above its per-frame
quantile) over Rayleigh speckle, split as the simulators are into a
deterministic ``nau_rain_from`` and the drawing ``synthesize_nau_rain``.
The per-frame threshold is ``jnp.quantile``'s, through
``metrics/roc.py::quantile``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.data.zy3 import smooth_noise_from
from onet_tpu_torch.metrics.roc import quantile
from onet_tpu_torch.ops.normalize import minmax_per_frame
from onet_tpu_torch.sim.targets import rayleigh_sample

RAIN_CUTOFF = 0.015


def load_nau_dict_pt(path: str, device=None) -> Tuple[ArrayDataset,
                                                       List[str]]:
    """Load a reference-format dict onto ``device`` (default: the card).
    Only tensors and plain containers are unpickled."""
    dev = resolve_device(device)
    d = torch.load(path, map_location="cpu", weights_only=True)
    ids = list(d.keys())
    imgs = torch.stack([d[i]["img"] for i in ids]).to(dev, torch.float32)
    labels = torch.stack([d[i]["label"] for i in ids]).to(dev, torch.float32)
    return ArrayDataset({"imgs": minmax_per_frame(imgs[..., None]),
                         "labels": labels}), ids


def nau_rain_from(bg: torch.Tensor, noise: torch.Tensor,
                  rain_cover: float = 0.25):
    """Rain frames from speckle ``bg`` and white ``noise`` (both [N, S, S]):
    the rain texture is the noise low-passed; the mask is where it exceeds
    its (1 - rain_cover) quantile; the echo adds 6x a soft ramp above that
    threshold. Returns (imgs [N, S, S, 1] min-max normalized per frame,
    masks [N, S, S] float32)."""
    rain = smooth_noise_from(noise, RAIN_CUTOFF)
    n = rain.shape[0]
    thresh = quantile(rain.reshape(n, -1), 1.0 - rain_cover)[:, None, None]
    mask = (rain > thresh).to(torch.float32)
    strength = torch.clamp((rain - thresh) / 0.1, 0.0, 1.0)
    return minmax_per_frame((bg + 6.0 * strength)[..., None]), mask


def synthesize_nau_rain(gen: torch.Generator, n: int = 10, size: int = 200,
                        rain_cover: float = 0.25, device=None):
    """Radar-like frames drawn from ``gen`` on ``device`` (default: the
    card; the generator must live there). Returns (ArrayDataset {imgs,
    labels}, ids)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, data on {dev}: draw "
                         "on the data's device")
    bg = rayleigh_sample(gen, (n, size, size))
    noise = torch.randn((n, size, size), generator=gen, device=dev)
    imgs, masks = nau_rain_from(bg, noise, rain_cover)
    return (ArrayDataset({"imgs": imgs, "labels": masks}),
            [f"nau_syn_{i:03d}" for i in range(n)])
