"""Onet: twin (optionally weight-shared) U-Nets, serving subset
(``onet_tpu/models/onet.py``).

The per-pixel projection V_i = <L_i, H_i> and S = softmax([V_t, V_d]);
``channel_dot`` keeps the reference's einsum broadcast quirk.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.models.unet import unet_init, tree_map

# Weight-shared twin pass layout: channel-stack the complementary branches
# at the 64-channel levels (models/infer.py::unet_infer_stacked).
CHANNEL_STACK = True

# Width-pair-packed 512^2 levels on the hand-written conv kernels
# (models/wp.py); applies only where wp_supported() holds.
PAIR_PACK = False


def onet_init(gen: torch.Generator, in_channels: int = 1, *,
              weight_share: bool = True, dtype=torch.float32,
              base: int = 64, device=None):
    """Returns (params, state) on ``device`` (default: the card; raises
    without one). Weights are drawn on the CPU from ``gen``, so a seed gives
    the same weights on every device; the twin draws its second net after
    the first."""
    dev = resolve_device(device)
    if weight_share:
        p, s = unet_init(gen, in_channels, dtype, base=base)
        params, state = {"top": p}, {"top": s}
    else:
        pt, st = unet_init(gen, in_channels, dtype, base=base)
        pd, sd = unet_init(gen, in_channels, dtype, base=base)
        params, state = {"top": pt, "down": pd}, {"top": st, "down": sd}
    to = lambda t: t.to(dev)   # noqa: E731
    return tree_map(to, params), tree_map(to, state)


def is_weight_shared(params) -> bool:
    return "down" not in params


def channel_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum('bpxy,bpxy->bxy') with torch broadcast semantics, NHWC:
    equal channel counts dot; a size-1 channel broadcasts against the
    other operand's channel sum."""
    ca, cb = a.shape[-1], b.shape[-1]
    if ca == cb:
        return torch.sum(a * b, dim=-1)
    if cb == 1:
        return torch.sum(a, dim=-1) * b[..., 0]
    if ca == 1:
        return a[..., 0] * torch.sum(b, dim=-1)
    raise ValueError(f"incompatible channel dims {ca} vs {cb}")


def stacked_head(loc, glob):
    """Per-branch head reductions on channel-stacked (loc, glob), in f32.
    Returns (v, lsum), both [B, H, W, 2]: v[..., b] = <L_b, H_b>,
    lsum[..., b] = sum_c L_b."""
    c = loc.shape[-1] // 2
    lf = loc.float()
    prod = lf * glob.float()
    v = prod.unflatten(-1, (2, c)).sum(-1)
    lsum = lf.unflatten(-1, (2, c)).sum(-1)
    return v, lsum


def predict_label(s: torch.Tensor) -> torch.Tensor:
    """argmax over the class pair: 0 = top wins, 1 = down wins. [B, H, W]."""
    return torch.argmax(s, dim=-1)


def get_label(vt: torch.Tensor, vd: torch.Tensor):
    """Re-softmax raw projection maps into (labels, probabilities)."""
    s = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
    return torch.argmax(s, dim=-1), s
