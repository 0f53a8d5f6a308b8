"""TransUNet twin Onet (``onet_tpu/models/transunet.py``).

The reference's hybrid ViT backbone ablation, rebuilt from the published
TransUNet and fitted to the Onet container:

* a light conv pyramid (three stride-2 conv -> LN -> GELU stages, skips at
  1/2, 1/4 and 1/8 with widths D/12, D/6, D/3) in place of the paper's
  pretrained ResNet-50, then a 2x2 patch-embed conv to D-wide tokens at
  1/16;
* ``depth`` pre-LN ViT blocks (ViT-B at the defaults: D 768, depth 12,
  D/64 heads, MLP 4x) with a learned position embedding sized for
  ``img_size`` and resized bilinearly for other grids, then a final LN;
* the CUP decoder: conv3x3 D -> D/3 on the token grid, then four stages of
  2x bilinear upsampling -> concat skip -> conv3x3 -> LN -> ReLU (widths
  D/6, D/12, D/12, D/48; the last without a skip);
* ``glob`` the last CUP features projected to 64 channels, ``loc`` the
  full-resolution conv stem; head and losses the Onet's.

Equivalences with the JAX functions used here: a stride-2 3x3 ``SAME``
conv pads (0, 1) on an even side, not (1, 1) (``_same_pad``);
``jax.image.resize(method="bilinear")`` is ``F.interpolate(mode=
"bilinear", align_corners=False, antialias=True)``, run in float32 and
cast back; global attention is ``models/swin.py``'s, its float32 softmax
included.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models.onet import stateless_onet_forward
from onet_tpu_torch.models.swin import (
    _attention, _dense, _gelu, _kaiming_normal, _layer_norm, _linear_init,
    _ln_init, _nchw, _nhwc, _stem, _stem_init, _trunc_normal, twin_init)

PATCH = 16  # total token stride: 3 pyramid halvings x 2x2 patch embed


def _same_pad(n: int, k: int, s: int) -> tuple:
    """XLA's SAME padding of one side: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, p, stride, policy: Policy, *, padding="SAME"):
    """Conv + bias with compute-dtype operands and result; ``padding``
    "SAME" (XLA's, asymmetric where the total is odd) or "VALID"."""
    w = policy.cast_compute(p["w"])
    xc = _nchw(policy.cast_compute(x))
    if padding == "SAME":
        kh, kw = w.shape[0], w.shape[1]
        ph = _same_pad(xc.shape[2], kh, stride)
        pw = _same_pad(xc.shape[3], kw, stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = _nhwc(F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride))
    if "b" in p:
        y = y + policy.cast_compute(p["b"])
    return y


def _conv_init(gen, kh, cin, cout, dtype=torch.float32):
    return {"w": _kaiming_normal(gen, (kh, kh, cin, cout), kh * kh * cin,
                                 dtype),
            "b": torch.zeros((cout,), dtype=dtype)}


def _resize(x, hw):
    """jax.image.resize(x, (N, *hw, C), "bilinear") on NHWC, in float32."""
    y = F.interpolate(_nchw(x.float()), size=hw, mode="bilinear",
                      align_corners=False, antialias=True)
    return _nhwc(y).to(x.dtype)


def _mhsa(p, x, *, heads, policy: Policy):
    """Global multi-head self-attention over tokens. x [N, L, D]."""
    n, l, d = x.shape
    dh = d // heads
    qkv = _dense(x, p["qkv"], policy)                        # [N, L, 3D]
    qkv = qkv.reshape(n, l, 3, heads, dh).permute(2, 0, 3, 1, 4)
    out = _attention(qkv[0], qkv[1], qkv[2], policy)         # [N, h, L, dh]
    out = out.permute(0, 2, 1, 3).reshape(n, l, d)
    return _dense(out, p["proj"], policy)


def _vit_block_init(gen, dim, mlp_ratio=4, dtype=torch.float32):
    return {
        "ln1": _ln_init(dim, dtype),
        "qkv": _linear_init(gen, dim, 3 * dim, dtype=dtype),
        "proj": _linear_init(gen, dim, dim, dtype=dtype),
        "ln2": _ln_init(dim, dtype),
        "fc1": _linear_init(gen, dim, mlp_ratio * dim, dtype=dtype),
        "fc2": _linear_init(gen, mlp_ratio * dim, dim, dtype=dtype),
    }


def _vit_block(p, x, *, heads, policy: Policy):
    x = x + _mhsa(p, _layer_norm(x, p["ln1"]), heads=heads, policy=policy)
    m = _dense(_layer_norm(x, p["ln2"]), p["fc1"], policy)
    m = _dense(_gelu(m), p["fc2"], policy)
    return x + m


def transunet_init(gen: torch.Generator, in_channels: int, *,
                   embed_dim: int = 768, depth: int = 12,
                   img_size: int = 224, out_dim: int = 64,
                   dtype=torch.float32):
    """Params of one TransUNet, on the CPU, drawn from ``gen`` (ViT-B at
    the defaults; ``embed_dim`` scales every width and must be divisible
    by 48, so the CUP widths D/3 .. D/48 stay whole)."""
    if embed_dim % 48:
        raise ValueError(f"embed_dim {embed_dim} must be divisible by 48 "
                         "(CUP decoder widths are D/3, D/6, D/12, D/48)")
    if img_size % PATCH:
        raise ValueError(f"img_size {img_size} must be divisible by {PATCH}")
    d = embed_dim
    d3, d6, d12, d48 = d // 3, d // 6, d // 12, d // 48
    p = {"stem": _stem_init(gen, in_channels, out_dim, dtype)}
    cin = in_channels
    for i, cout in enumerate((d12, d6, d3)):
        p[f"pyr{i}"] = dict(_conv_init(gen, 3, cin, cout, dtype),
                            ln=_ln_init(cout, dtype))
        cin = cout
    p["embed"] = _conv_init(gen, 2, d3, d, dtype)
    grid = img_size // PATCH
    p["pos"] = _trunc_normal(gen, (grid, grid, d), dtype=dtype)
    p["blocks"] = [_vit_block_init(gen, d, dtype=dtype)
                   for _ in range(depth)]
    p["enc_ln"] = _ln_init(d, dtype)
    p["more"] = dict(_conv_init(gen, 3, d, d3, dtype), ln=_ln_init(d3, dtype))
    for i, (cin, cout) in enumerate(((d3 + d3, d6), (d6 + d6, d12),
                                     (d12 + d12, d12), (d12, d48))):
        p[f"dec{i}"] = dict(_conv_init(gen, 3, cin, cout, dtype),
                            ln=_ln_init(cout, dtype))
    p["out"] = _linear_init(gen, d48, out_dim, dtype=dtype)
    return p


def transunet_apply(params, x, *, policy: Policy = DEFAULT):
    """x [N, H, W, Cin] -> (loc [N, H, W, 64], glob [N, H, W, 64])."""
    n, h, w, _ = x.shape
    if h % PATCH or w % PATCH:
        raise ValueError(f"input {h}x{w} must be divisible by {PATCH}")
    loc = _stem(params["stem"], policy.cast_compute(x), policy)

    e = policy.cast_compute(x)
    skips = []
    for i in range(3):
        pp = params[f"pyr{i}"]
        e = _gelu(_layer_norm(_conv(e, pp, 2, policy), pp["ln"]))
        skips.append(e)

    t = _conv(e, params["embed"], 2, policy, padding="VALID")
    gh, gw, d = t.shape[1], t.shape[2], t.shape[3]
    pos = params["pos"].float()
    if tuple(pos.shape[:2]) != (gh, gw):
        pos = _resize(pos[None], (gh, gw))[0]
    t = (t.float() + pos[None]).to(policy.compute_dtype)
    t = t.reshape(n, gh * gw, d)
    heads = max(1, d // 64)
    for bp in params["blocks"]:
        t = _vit_block(bp, t, heads=heads, policy=policy)
    t = _layer_norm(t, params["enc_ln"]).reshape(n, gh, gw, d)

    mp = params["more"]
    e = torch.relu(_layer_norm(_conv(t, mp, 1, policy), mp["ln"]))
    for i, skip in enumerate((skips[2], skips[1], skips[0], None)):
        e = _resize(e, (2 * e.shape[1], 2 * e.shape[2]))
        if skip is not None:
            e = torch.cat([e, skip], dim=-1)
        dp = params[f"dec{i}"]
        e = torch.relu(_layer_norm(_conv(e, dp, 1, policy), dp["ln"]))
    return loc, _dense(e, params["out"], policy)


def transunet_onet_init(gen: torch.Generator, in_channels: int = 3, *,
                        weight_share: bool = True, embed_dim: int = 768,
                        depth: int = 12, img_size: int = 224,
                        dtype=torch.float32, device=None):
    """(params, state) on ``device`` (default: the card); the state is the
    stateless backbones' empty dicts (``models/swin.py::twin_init``)."""
    return twin_init(
        lambda g: transunet_init(g, in_channels, embed_dim=embed_dim,
                                 depth=depth, img_size=img_size,
                                 dtype=dtype),
        gen, weight_share, device)


def transunet_onet_forward(params, state, x, *, train: bool = False,
                           bias: float = 0.0, policy: Policy = DEFAULT,
                           ops=None, channel_stack=None, pair_pack=None):
    """The Onet forward with the TransUNet backbone; signature as
    ``models/onet.py::onet_forward``'s."""
    del train, ops, channel_stack, pair_pack
    return stateless_onet_forward(transunet_apply, params, state, x,
                                  bias=bias, policy=policy)
