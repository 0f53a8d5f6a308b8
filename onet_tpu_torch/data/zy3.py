"""ZY-3 cloud-detection data (``onet_tpu/data/zy3.py``).

Sources:
* reference-format .pt dicts {img_id: {'true_color': [3, 224, 224],
  'mask': [224, 224]}}: ``load_zy3_dict_pt`` puts them on the device as
  NHWC images, the id list kept on the host;
* ``synthesize_zy3``: cloudy scenes (low-pass noise clouds over smooth
  tinted terrain) standing in for the ZY-3 imagery, and
  ``synthesize_cloud_addition``, the cloud-addition composites.

Every function of the JAX package that draws is split, as the simulators
are: a deterministic part takes the drawn white noise and tints
(``smooth_noise_from``, ``zy3_scene_from``, ``cloud_addition_from``), so
it is held against the JAX package on JAX's own draws, and a wrapper draws
them from a ``torch.Generator`` on its device. The cloud threshold is
``jnp.quantile``'s, through ``metrics/roc.py::quantile``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.metrics.roc import quantile

TERRAIN_CUTOFF, CLOUD_CUTOFF = 0.04, 0.02
CLOUD_RAMP, CLOUD_WHITE = 0.12, 0.95


def load_zy3_dict_pt(path: str, device=None) -> Tuple[ArrayDataset,
                                                      List[str]]:
    """Load a reference-format {id: {'true_color', 'mask'}} dict onto
    ``device`` (default: the card): imgs [N, H, W, 3], and labels [N, H, W]
    where every entry has a mask. Only tensors and plain containers are
    unpickled."""
    dev = resolve_device(device)
    d = torch.load(path, map_location="cpu", weights_only=True)
    ids = list(d.keys())
    imgs = torch.stack([d[i]["true_color"] for i in ids]).permute(0, 2, 3, 1)
    data = {"imgs": imgs.to(dev, torch.float32).contiguous()}
    if all("mask" in d[i] for i in ids):
        data["labels"] = torch.stack([d[i]["mask"] for i in ids]).to(
            dev, torch.float32)
    return ArrayDataset(data), ids


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


def _clouds(noise_c: torch.Tensor, cloud_cover: float):
    """(mask [N, H, W], alpha [N, H, W, 1]): the cloud texture above its
    per-frame (1 - cloud_cover) quantile, and its soft edge."""
    cl = smooth_noise_from(noise_c, CLOUD_CUTOFF)
    n = cl.shape[0]
    thresh = quantile(cl.reshape(n, -1), 1.0 - cloud_cover)[:, None, None]
    mask = (cl > thresh).to(torch.float32)
    alpha = torch.clamp((cl - thresh) / CLOUD_RAMP, 0.0, 1.0)[..., None]
    return mask, alpha


def zy3_scene_from(noise_t: torch.Tensor, noise_c: torch.Tensor,
                   tint: torch.Tensor, cloud_cover: float = 0.35):
    """Cloudy RGB scenes from white noise ``noise_t`` (terrain) and
    ``noise_c`` (clouds), both [N, S, S], and terrain tints [N, 3] in
    [0.15, 0.55): terrain * tint + 0.15 under white (0.95) clouds with a
    soft edge. Returns (imgs [N, S, S, 3] in [0, 1], masks [N, S, S])."""
    terrain = smooth_noise_from(noise_t, TERRAIN_CUTOFF)
    rgb = terrain[..., None] * tint[:, None, None, :] + 0.15
    mask, alpha = _clouds(noise_c, cloud_cover)
    img = rgb * (1 - alpha) + alpha * CLOUD_WHITE
    return torch.clamp(img, 0, 1), mask


def _draw(gen: torch.Generator, n: int, size: int, lo: float, hi: float,
          device):
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, data on {dev}: draw "
                         "on the data's device")
    noise_t = torch.randn((n, size, size), generator=gen, device=dev)
    noise_c = torch.randn((n, size, size), generator=gen, device=dev)
    tint = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    return noise_t, noise_c, tint


def synthesize_zy3(gen: torch.Generator, n: int = 16, size: int = 224,
                   cloud_cover: float = 0.35, device=None):
    """``n`` cloudy RGB scenes and binary cloud masks drawn from ``gen`` on
    ``device`` (default: the card; the generator must live there).
    Returns (ArrayDataset {imgs, labels}, ids)."""
    imgs, masks = zy3_scene_from(*_draw(gen, n, size, 0.15, 0.55, device),
                                 cloud_cover)
    return (ArrayDataset({"imgs": imgs, "labels": masks}),
            [f"zy3_syn_{i:04d}" for i in range(n)])


def split_snow_mask(labels: torch.Tensor):
    """3-valued ZY-3 masks -> (cloud == 1, snow == 2) float maps."""
    return (labels == 1).to(torch.float32), (labels == 2).to(torch.float32)


def cloud_addition_from(noise_t: torch.Tensor, noise_c: torch.Tensor,
                        tint: torch.Tensor, cloud_cover: float = 0.35):
    """Cloud-addition composites from drawn noise and tints [N, 3] in
    [0.3, 0.8): a cloudless bright terrain clip(base * tint + 0.2, 0, 1)
    and the same terrain under synthetic clouds. Returns (terrain,
    composite [N, S, S, 3], masks [N, S, S])."""
    base = smooth_noise_from(noise_t, TERRAIN_CUTOFF)
    terrain = torch.clamp(base[..., None] * tint[:, None, None, :] + 0.2,
                          0, 1)
    mask, alpha = _clouds(noise_c, cloud_cover)
    composite = torch.clamp(terrain * (1 - alpha) + alpha * CLOUD_WHITE, 0, 1)
    return terrain, composite, mask


def synthesize_cloud_addition(gen: torch.Generator, n: int = 8,
                              size: int = 224, cloud_cover: float = 0.35,
                              device=None):
    """Cloud-addition composites drawn from ``gen`` on ``device``. Returns
    (ArrayDataset {terrain, imgs, labels}, ids): 'imgs' is the composite,
    'terrain' the clean background."""
    terrain, imgs, masks = cloud_addition_from(
        *_draw(gen, n, size, 0.3, 0.8, device), cloud_cover)
    return (ArrayDataset({"terrain": terrain, "imgs": imgs, "labels": masks}),
            [f"zy3_add_{i:04d}" for i in range(n)])


def supervised_batches(gen: torch.Generator, ds: ArrayDataset, ids,
                       batch_sz: int, *, aug: bool = True,
                       snow_split: bool = False):
    """Batches of (imgs, labels[, cloud, snow], ids), the augmentation
    applied jointly to image and mask (geometric steps move both,
    photometric ones the image only). With ``aug`` the order is shuffled
    and each batch's choices drawn from ``gen`` (on the data's device);
    with ``snow_split`` the {0, 1, 2} mask also splits into cloud == 1 and
    snow == 2 maps."""
    from onet_tpu_torch.data.augment import augment_batch_with_masks

    n = len(ds)
    order = (torch.randperm(n, generator=gen, device=ds.device) if aug
             else torch.arange(n, device=ds.device))
    host_order = order.tolist()            # one read: the ids' order
    for lo in range(0, n, batch_sz):
        sel = order[lo:lo + batch_sz]
        imgs, masks = ds["imgs"][sel], ds["labels"][sel]
        if aug:
            imgs, masks = augment_batch_with_masks(gen, imgs, masks)
        out = {"imgs": imgs, "labels": masks,
               "ids": [ids[i] for i in host_order[lo:lo + batch_sz]]}
        if snow_split:
            out["cloud"], out["snow"] = split_snow_mask(masks)
        yield out
