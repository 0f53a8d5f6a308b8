"""He-2009 dark-channel dehazing on the device (``onet_tpu/preprocess/haze.py``).

The reference dehazes each image on the host with cv2 (ZY-3 parameters:
sz=3, radius=3, eps=1e-4, tx=0.3). Here every stage is a tensor function
on a batch of frames [N, H, W, 3] (float, in [0, 1]), so the haze terms
of a batch of thumbnails come from one pass.

The reference's quirks are kept:
* the atmospheric light averages the numpx - 1 brightest dark-channel
  pixels but divides by numpx (its loop starts at 1); the top set is taken
  with the lower index first among equal values, as XLA's ``top_k``
  orders them (a stable descending sort: ``torch.topk`` gives no order
  among ties, and the dark channel, an erosion, is full of them);
* the guided filter's gray guide uses cv2's BGR weights on RGB (gray =
  0.114 R + 0.587 G + 0.299 B);
* the erosion's border is +inf (cv2's default for a min filter), the box
  mean's border reflect-101 (cv2.boxFilter's);
* below 2000 px (numpx == 1) the reference leaves the light at 0 and
  divides by it; the JAX package clamps it at 1e-6 so the chain stays
  finite, and so does the port. For a 224^2 thumbnail (numpx = 50) the
  clamp is inert.

Window sums add their terms in row-major window order, as XLA's
``reduce_window`` does, so the means agree with the JAX package's op-by-op
run to the last bits where the inputs do. The light's sum is taken in
float64 and every division by a constant divides by a tensor (``div``),
so each step is elementwise or exact and the card computes what the CPU
computes, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onet_tpu_torch.ops.math import div


def _window(x: torch.Tensor, sz: int, op) -> torch.Tensor:
    """op-reduce of sz x sz windows of a padded [N, H + sz - 1, W + sz - 1]
    -> [N, H, W], terms combined in row-major window order."""
    h, w = x.shape[1] - sz + 1, x.shape[2] - sz + 1
    acc = None
    for dy in range(sz):
        for dx in range(sz):
            v = x[:, dy:dy + h, dx:dx + w]
            acc = v if acc is None else op(acc, v)
    return acc


def _pads(sz: int):
    lo = (sz - 1) // 2
    return (lo, sz - 1 - lo, lo, sz - 1 - lo)


def _min_pool(x: torch.Tensor, sz: int) -> torch.Tensor:
    """sz x sz erosion (min filter) of [N, H, W], same size, +inf border."""
    xp = F.pad(x, _pads(sz), value=float("inf"))
    return _window(xp, sz, torch.minimum)


def _box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """cv2.boxFilter(ksize=(r, r), normalize=True) of [N, H, W] with its
    reflect-101 border."""
    xp = F.pad(x[:, None], _pads(r), mode="reflect")[:, 0]
    return div(_window(xp, r, torch.add), r * r)


def dark_channel(im: torch.Tensor, sz: int = 15) -> torch.Tensor:
    """Min over RGB, then an sz x sz erosion. im [N, H, W, 3] -> [N, H, W]."""
    return _min_pool(torch.amin(im, dim=-1), sz)


def atm_light(im: torch.Tensor, dark: torch.Tensor) -> torch.Tensor:
    """Atmospheric light [N, 3] from the top-0.1% dark-channel pixels of
    each frame (the brightest numpx, lower index first among equals; the
    last of them dropped, the sum divided by numpx)."""
    n, h, w = dark.shape
    numpx = max((h * w) // 1000, 1)
    order = torch.sort(dark.reshape(n, -1), dim=1, descending=True,
                       stable=True).indices
    if numpx == 1:
        return torch.zeros((n, 3), dtype=im.dtype, device=im.device)
    idx = order[:, :numpx - 1, None].expand(-1, -1, 3)
    take = torch.gather(im.reshape(n, -1, 3), 1, idx)
    # summed in float64, so the card and the CPU round the same sum
    return div(torch.sum(take.double(), dim=1), numpx).to(im.dtype)


def transmission_estimate(im: torch.Tensor, a: torch.Tensor, sz: int = 15,
                          omega: float = 0.95) -> torch.Tensor:
    a_safe = torch.clamp_min(a, 1e-6)
    return 1.0 - omega * dark_channel(im / a_safe[:, None, None, :], sz)


def guided_filter(guide: torch.Tensor, p: torch.Tensor, r: int,
                  eps: float) -> torch.Tensor:
    mean_i = _box_mean(guide, r)
    mean_p = _box_mean(p, r)
    mean_ip = _box_mean(guide * p, r)
    cov_ip = mean_ip - mean_i * mean_p
    var_i = _box_mean(guide * guide, r) - mean_i * mean_i
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return _box_mean(a, r) * guide + _box_mean(b, r)


def transmission_refine(im: torch.Tensor, et: torch.Tensor,
                        radius: int = 15, eps: float = 1e-4) -> torch.Tensor:
    # cv2's BGR2GRAY weights on an RGB array, as the reference applies them
    gray = 0.114 * im[..., 0] + 0.587 * im[..., 1] + 0.299 * im[..., 2]
    return guided_filter(gray, et, radius, eps)


def recover(im: torch.Tensor, t: torch.Tensor, a: torch.Tensor,
            tx: float = 0.1) -> torch.Tensor:
    t = torch.clamp_min(t, tx)[..., None]
    return (im - a[:, None, None, :]) / t + a[:, None, None, :]


def dehaze(im: torch.Tensor, *, sz: int = 3, radius: int = 3,
           eps: float = 1e-4, tx: float = 0.3):
    """The pipeline on [N, H, W, 3] or one [H, W, 3] frame -> (J dehazed,
    K cloud radiance [.., H, W]) with the reference's ZY-3 parameters:
    J = Recover(tx=0.3), K = max(A) * (1 - t)."""
    one = im.ndim == 3
    if one:
        im = im[None]
    dark = dark_channel(im, sz)
    a = atm_light(im, dark)
    te = transmission_estimate(im, a, sz)
    t = transmission_refine(im, te, radius, eps)
    j = recover(im, t, a, tx)
    k = torch.amax(a, dim=1)[:, None, None] * (1.0 - t)
    return (j[0], k[0]) if one else (j, k)


def haze_radiance(im: torch.Tensor, **kw) -> torch.Tensor:
    """K only (the haze_enhance preprocessing options)."""
    return dehaze(im, **kw)[1]
