"""Cell-averaging CFAR baseline segmenter (``onet_tpu/metrics/cfar.py``).

The reference's NAU rain experiment compares Onet against a CA-CFAR
detector (``CFAR(kval, nref=16, mguide=8).cfar_seg(img)``; kval 2.0 lands
near far 0.03). Per pixel, the background level is the mean over a
reference annulus, the outer ``(2*nref+1)²`` window minus the inner
``(2*mguide+1)²`` guard window, clipped at the borders with the counts
adjusted; a detection is ``intensity > kval * background``.

Formulation: an integral image (two cumsums) and four gathers per window,
batched over frames with tensor ops: no per-frame loop. The JAX package
leaves this to XLA and reaches no Pallas kernel, so plain torch ops are its
port. The float32 integral image of a 200² frame sums to ~4e4, and
``torch.cumsum`` adds in another order than XLA, so pixels within rounding
of ``kval * bg`` can come out the other way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _integral(imgs: torch.Tensor) -> torch.Tensor:
    """[N, H, W] -> [N, H+1, W+1] summed-area tables, zero top row/col."""
    return F.pad(torch.cumsum(torch.cumsum(imgs, dim=1), dim=2), (1, 0, 1, 0))


def _window_sums(ii: torch.Tensor, h: int, w: int, r: int):
    """Per-pixel sums over the clipped centered (2r+1)² window.
    Returns (sums [N, H, W], counts [H, W])."""
    ys = torch.arange(h, device=ii.device)
    xs = torch.arange(w, device=ii.device)
    y0, y1 = (ys - r).clamp(0, h)[:, None], (ys + r + 1).clamp(0, h)[:, None]
    x0, x1 = (xs - r).clamp(0, w)[None, :], (xs + r + 1).clamp(0, w)[None, :]
    sums = (ii[:, y1, x1] - ii[:, y0, x1] - ii[:, y1, x0] + ii[:, y0, x0])
    return sums, (y1 - y0) * (x1 - x0)


def cfar_seg_batch(imgs: torch.Tensor, kval: float = 2.0, *, nref: int = 16,
                   mguide: int = 8) -> torch.Tensor:
    """Batched CA-CFAR: [N, H, W] or [N, H, W, 1] -> [N, H, W] int32 {0, 1}.
    ``nref``/``mguide`` are the outer/guard half-widths (the reference
    calls ``CFAR(kval=2.0, nref=16, mguide=8)``)."""
    if not nref > mguide >= 0:
        raise ValueError(f"need nref > mguide >= 0, got {nref}, {mguide}")
    if imgs.ndim == 4:
        imgs = imgs[..., 0]
    imgs = imgs.to(torch.float32)
    _, h, w = imgs.shape
    ii = _integral(imgs)
    ref_sum, ref_cnt = _window_sums(ii, h, w, nref)
    g_sum, g_cnt = _window_sums(ii, h, w, mguide)
    bg = (ref_sum - g_sum) / torch.clamp_min(ref_cnt - g_cnt, 1)
    return (imgs > kval * bg).to(torch.int32)


def cfar_seg(img: torch.Tensor, kval: float = 2.0, *, nref: int = 16,
             mguide: int = 8) -> torch.Tensor:
    """CA-CFAR detection map for one [H, W] frame (int32 {0, 1})."""
    return cfar_seg_batch(img[None], kval, nref=nref, mguide=mguide)[0]
