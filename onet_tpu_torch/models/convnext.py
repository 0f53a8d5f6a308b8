"""ConvNeXt-UNet twin Onet (``onet_tpu/models/convnext.py``).

The reference's modern-conv backbone ablation, rebuilt from the published
ConvNeXt and fitted to the Onet container: a 4x4 patch-embed conv (stride
4), four ConvNeXt stages (depthwise 7x7 -> LN -> pointwise 4x MLP with
GELU -> layer scale -> residual) with 2x2 stride-2 downsample convs between
them (ConvNeXt-T: dims 96-192-384-768, depths 3-3-9-3), a mirrored light
decoder (Swin-Unet's patch expand and linear skip fusion, 2 blocks a
stage) and a final 4x expand to full resolution. ``glob`` is the decoder's
features projected to 64 channels, ``loc`` the full-resolution conv stem;
the head and the losses are the Onet's
(``models/onet.py::stateless_onet_forward``).

The depthwise conv is a grouped ``F.conv2d`` (one filter per channel, the
JAX package's ``feature_group_count=C``); the layer-scale gammas start at
1e-6 as published. The primitives and their arithmetic are Swin-Unet's
(``models/swin.py``).
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models.onet import stateless_onet_forward
from onet_tpu_torch.models.swin import (
    _conv_nhwc, _decode, _dense, _embed_init, _final_init, _gelu,
    _layer_norm, _linear_init, _ln_init, _patch_embed, _stem, _stem_init,
    _trunc_normal, _up_init, twin_init)

PATCH = 4


def _dwconv(x, w, policy: Policy):
    """Depthwise 7x7 SAME conv, one filter per channel. w [7, 7, 1, C]."""
    return _conv_nhwc(policy.cast_compute(x), policy.cast_compute(w),
                      padding=3, groups=x.shape[-1])


def _block_init(gen, dim, mlp_ratio=4, dtype=torch.float32):
    return {
        "dw": _trunc_normal(gen, (7, 7, 1, dim), dtype=dtype),
        "dwb": torch.zeros((dim,), dtype=dtype),
        "ln": _ln_init(dim, dtype),
        "fc1": _linear_init(gen, dim, mlp_ratio * dim, dtype=dtype),
        "fc2": _linear_init(gen, mlp_ratio * dim, dim, dtype=dtype),
        "gamma": torch.full((dim,), 1e-6, dtype=dtype),
    }


def _block(p, x, policy: Policy):
    h = _dwconv(x, p["dw"], policy) + p["dwb"].to(policy.compute_dtype)
    h = _layer_norm(h, p["ln"])
    h = _dense(h, p["fc1"], policy)
    h = _dense(_gelu(h), p["fc2"], policy)
    return x + h * p["gamma"].to(h.dtype)


def convnext_unet_init(gen: torch.Generator, in_channels: int, *,
                       embed_dim: int = 96, depths=(3, 3, 9, 3),
                       dec_depth: int = 2, out_dim: int = 64,
                       dtype=torch.float32):
    """Params of one ConvNeXt-UNet, on the CPU, drawn from ``gen``
    (ConvNeXt-T geometry by default; ``embed_dim`` scales every width)."""
    dims = [embed_dim * (2 ** i) for i in range(4)]
    p = {"stem": _stem_init(gen, in_channels, out_dim, dtype),
         "embed": _embed_init(gen, in_channels, PATCH, dims[0], dtype)}
    for i in range(4):                                    # encoder stages
        p[f"enc{i}"] = [_block_init(gen, dims[i], dtype=dtype)
                        for _ in range(depths[i])]
        if i < 3:                                         # downsample convs
            p[f"down{i}"] = {
                "ln": _ln_init(dims[i], dtype),
                "w": _trunc_normal(gen, (2, 2, dims[i], dims[i + 1]),
                                   dtype=dtype),
                "b": torch.zeros((dims[i + 1],), dtype=dtype)}
    for i in (2, 1, 0):                                   # decoder stages
        p[f"up{i}"] = _up_init(gen, dims[i], dtype)
        p[f"fuse{i}"] = _linear_init(gen, 2 * dims[i], dims[i], bias=False,
                                     dtype=dtype)
        p[f"dec{i}"] = [_block_init(gen, dims[i], dtype=dtype)
                        for _ in range(dec_depth)]
    p["final"] = _final_init(gen, dims[0], dtype)
    p["out"] = _linear_init(gen, dims[0], out_dim, dtype=dtype)
    return p


def convnext_unet_apply(params, x, *, policy: Policy = DEFAULT):
    """x [N, H, W, Cin] -> (loc [N, H, W, 64], glob [N, H, W, 64])."""
    n, h, w, _ = x.shape
    if h % (PATCH * 8) or w % (PATCH * 8):
        raise ValueError(f"input {h}x{w} must be divisible by {PATCH * 8}")
    xc = policy.cast_compute(x)
    loc = _stem(params["stem"], xc, policy)
    e = _patch_embed(params["embed"], xc, PATCH, policy)

    skips = []
    for i in range(4):
        for bp in params[f"enc{i}"]:
            e = _block(bp, e, policy)
        if i < 3:
            skips.append(e)
            d = params[f"down{i}"]
            e = _conv_nhwc(_layer_norm(e, d["ln"]),
                           policy.cast_compute(d["w"]), stride=2)
            e = e + policy.cast_compute(d["b"])

    def stage(i, e):
        for bp in params[f"dec{i}"]:
            e = _block(bp, e, policy)
        return e

    return loc, _decode(params, e, skips, policy, stage)


def convnext_onet_init(gen: torch.Generator, in_channels: int = 3, *,
                       weight_share: bool = True, embed_dim: int = 96,
                       depths=(3, 3, 9, 3), dtype=torch.float32,
                       device=None):
    """(params, state) on ``device`` (default: the card); the state is the
    stateless backbones' empty dicts (``models/swin.py::twin_init``)."""
    return twin_init(
        lambda g: convnext_unet_init(g, in_channels, embed_dim=embed_dim,
                                     depths=depths, dtype=dtype),
        gen, weight_share, device)


def convnext_onet_forward(params, state, x, *, train: bool = False,
                          bias: float = 0.0, policy: Policy = DEFAULT,
                          ops=None, channel_stack=None, pair_pack=None):
    """The Onet forward with the ConvNeXt-UNet backbone; signature as
    ``models/onet.py::onet_forward``'s."""
    del train, ops, channel_stack, pair_pack
    return stateless_onet_forward(convnext_unet_apply, params, state, x,
                                  bias=bias, policy=policy)
