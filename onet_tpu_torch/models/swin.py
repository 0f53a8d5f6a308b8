"""Swin-Unet twin Onet (``onet_tpu/models/swin.py``).

The reference's transformer-backbone ablation, rebuilt from the published
Swin Transformer and Swin-Unet and fitted to the Onet container: a 4x4
patch embed, three Swin stages (window and shifted-window attention, patch
merging), a bottleneck stage, a mirrored decoder (patch expanding and a
linear skip fusion) and a final 4x expand to full resolution; Swin-T
geometry by default (embed 96, depths 2-2-2-2, heads 3-6-12-24, window 7,
MLP ratio 4). ``glob`` is the decoder's full-resolution features projected
to 64 channels, ``loc`` a full-resolution conv stem (3x3 -> LN -> GELU ->
64). The head and the losses are the Onet's
(``models/onet.py::stateless_onet_forward``).

The shared primitives here (``_trunc_normal``, ``_linear_init``,
``_ln_init``, ``_layer_norm``, ``_dense``) are the ConvNeXt and TransUNet
families' too. Their arithmetic follows the JAX package's:

* LayerNorm takes two passes in float32 (the mean, then the mean of the
  squared deviations) and casts the result back to the input's dtype;
* ``_dense`` multiplies in the compute dtype, adds the float32 bias and
  casts to the compute dtype. In float32 this is the JAX function; in bf16
  the product is rounded to bf16 before the bias is added, where XLA
  rounds once after it;
* the attention logits are float32 products of the compute-dtype q and k,
  the softmax runs in float32 and is cast to the compute dtype before the
  value product;
* GELU is the tanh approximation (``jax.nn.gelu``'s default).

Weights are drawn on the CPU from a ``torch.Generator`` where the JAX
package takes a key (``jax.random.truncated_normal`` there, the inverse
CDF of a uniform draw here: the same law, other numbers), then moved to
``device`` (default: the card; raises without one). The relative-position
index and the shift masks are built with numpy once per geometry and kept
on the device they are used on.

Each window attention (the roll, the partition, the products, the bias and
mask, the softmax and the reverse) is the span ``swin.window_attention``
and each LayerNorm the span ``layer_norm`` (``utils/profiling.py``); the
counters ``swin.windows`` and ``swin.shifted_windows`` add the windows a
forward attends, images x windows.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models.onet import stateless_onet_forward
from onet_tpu_torch.models.unet import tree_map
from onet_tpu_torch.utils.profiling import count, span


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

_ERF_LO, _ERF_HI = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))


def _trunc_normal(gen, shape, std=0.02, dtype=torch.float32):
    """A normal truncated to +-2 standard deviations, times ``std``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(_ERF_LO + (_ERF_HI - _ERF_LO) * u)
    return (torch.clamp(z, -2.0, 2.0) * std).to(dtype)


def _kaiming_normal(gen, shape, fan_in, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * math.sqrt(2.0 / fan_in)).to(dtype)


def _linear_init(gen, din, dout, *, bias=True, dtype=torch.float32):
    p = {"w": _trunc_normal(gen, (din, dout), dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype)
    return p


def _ln_init(dim, dtype=torch.float32):
    return {"g": torch.ones((dim,), dtype=dtype),
            "b": torch.zeros((dim,), dtype=dtype)}


def _layer_norm(x, p, eps=1e-5):
    with span("layer_norm"):
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["g"].float() + p["b"].float()
        return y.to(x.dtype)


def _dense(x, p, policy: Policy):
    y = torch.matmul(policy.cast_compute(x), policy.cast_compute(p["w"]))
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(policy.compute_dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_nhwc(x, w, *, stride=1, padding=0, groups=1):
    """NHWC conv with an HWIO weight; ``padding`` as F.conv2d takes it."""
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride,
                          padding=padding, groups=groups))


def _stem(p, xc, policy: Policy):
    """The full-resolution 'loc' path: 3x3 SAME conv -> LN -> GELU."""
    loc = _conv_nhwc(xc, policy.cast_compute(p["w"]), padding=1)
    return _gelu(_layer_norm(loc, p["ln"]))


def _patch_embed(p, xc, patch, policy: Policy):
    """patch x patch stride-patch VALID conv + bias -> LN."""
    e = _conv_nhwc(xc, policy.cast_compute(p["w"]), stride=patch)
    e = e + policy.cast_compute(p["b"])
    return _layer_norm(e, p["ln"])


# ---------------------------------------------------------------------------
# window attention
# ---------------------------------------------------------------------------

def _rel_pos_index(window: int) -> np.ndarray:
    """[T, T] indices into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))          # [2, w, w]
    flat = coords.reshape(2, -1)                            # [2, T]
    rel = flat[:, :, None] - flat[:, None, :]               # [2, T, T]
    rel = rel.transpose(1, 2, 0) + (window - 1)             # to >= 0
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """[nW, T, T] additive mask for shifted-window attention (0 within a
    contiguous region, -100 across the cyclic-shift seams)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, h - window), slice(h - window, h - shift),
               slice(h - shift, h)):
        for ws in (slice(0, w - window), slice(w - window, w - shift),
                   slice(w - shift, w)):
            img[hs, ws] = cnt
            cnt += 1
    ids = img.reshape(h // window, window, w // window, window)
    ids = ids.transpose(0, 2, 1, 3).reshape(-1, window * window)  # [nW, T]
    return np.where(ids[:, :, None] != ids[:, None, :],
                    -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_pos_index_on(window: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_rel_pos_index(window), dtype=torch.int64,
                           device=device)


@functools.lru_cache(maxsize=None)
def _shift_mask_on(h: int, w: int, window: int, shift: int,
                   device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_shift_mask(h, w, window, shift), device=device)


def _attn_init(gen, dim, heads, window, dtype=torch.float32):
    return {
        "qkv": _linear_init(gen, dim, 3 * dim, dtype=dtype),
        "proj": _linear_init(gen, dim, dim, dtype=dtype),
        "rpb": _trunc_normal(gen, ((2 * window - 1) ** 2, heads),
                             dtype=dtype),
    }


def _attention(q, k, v, policy: Policy, bias=None):
    """softmax(q k^T / sqrt(dh) [+ bias]) v over [..., T, dh]: float32
    logits and softmax, the probabilities cast to the compute dtype for
    the value product."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = attn * (q.shape[-1] ** -0.5)
    if bias is not None:
        attn = bias(attn)
    attn = torch.softmax(attn, dim=-1).to(policy.compute_dtype)
    return torch.matmul(attn, policy.cast_compute(v))


def _window_attention(p, x, *, heads, window, shift, policy: Policy):
    n, h, w, _ = x.shape
    windows = n * (h // window) * (w // window)
    count("swin.windows", windows)
    if shift:
        count("swin.shifted_windows", windows)
    with span("swin.window_attention"):
        return _attend(p, x, heads=heads, window=window, shift=shift,
                       policy=policy)


def _attend(p, x, *, heads, window, shift, policy: Policy):
    n, h, w, d = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nh, nw = h // window, w // window
    t = window * window
    xw = x.reshape(n, nh, window, nw, window, d)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(n * nh * nw, t, d)

    dh = d // heads
    qkv = _dense(xw, p["qkv"], policy)                       # [B_, T, 3D]
    qkv = qkv.reshape(-1, t, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                         # [B_, nh, T, dh]
    idx = _rel_pos_index_on(window, x.device)
    rel = p["rpb"].float()[idx].permute(2, 0, 1)[None]       # [1, nh, T, T]

    def bias(attn):
        attn = attn + rel
        if shift:
            mask = _shift_mask_on(h, w, window, shift, x.device)  # [nW, T, T]
            attn = (attn.reshape(n, nh * nw, heads, t, t)
                    + mask[None, :, None]).reshape(n * nh * nw, heads, t, t)
        return attn

    out = _attention(q, k, v, policy, bias)
    out = out.permute(0, 2, 1, 3).reshape(n * nh * nw, t, d)
    out = _dense(out, p["proj"], policy)
    out = out.reshape(n, nh, nw, window, window, d)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, d)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


# ---------------------------------------------------------------------------
# blocks / stages
# ---------------------------------------------------------------------------

def _block_init(gen, dim, heads, window, mlp_ratio, dtype=torch.float32):
    attn = _attn_init(gen, dim, heads, window, dtype)
    hidden = dim * mlp_ratio
    return {
        "ln1": _ln_init(dim, dtype),
        "attn": attn,
        "ln2": _ln_init(dim, dtype),
        "fc1": _linear_init(gen, dim, hidden, dtype=dtype),
        "fc2": _linear_init(gen, hidden, dim, dtype=dtype),
    }


def _block(p, x, *, heads, window, shift, policy: Policy):
    h = _window_attention(p["attn"], _layer_norm(x, p["ln1"]),
                          heads=heads, window=window, shift=shift,
                          policy=policy)
    x = x + h
    m = _dense(_layer_norm(x, p["ln2"]), p["fc1"], policy)
    m = _dense(_gelu(m), p["fc2"], policy)
    return x + m


def _stage(blocks, x, *, heads, window, policy: Policy):
    """Alternating W-MSA / SW-MSA blocks; no shift where the feature map is
    not larger than one window (the published rule)."""
    shift = window // 2 if x.shape[1] > window else 0
    for i, bp in enumerate(blocks):
        x = _block(bp, x, heads=heads, window=window,
                   shift=shift if i % 2 else 0, policy=policy)
    return x


def _merge(p, x, policy: Policy):
    """Patch merging: 2x2 neighborhood concat -> LN -> linear 4D -> 2D."""
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                   x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    return _dense(_layer_norm(x, p["ln"]), {"w": p["w_only"]}, policy)


def _shuffle_up(x, r):
    """[N, H, W, r*r*C] -> [N, rH, rW, C] (out[r*i+a, r*j+b] = block a, b)."""
    n, h, w, rrc = x.shape
    c = rrc // (r * r)
    x = x.reshape(n, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, r * h, r * w, c)


def _expand(p, x, policy: Policy):
    """Patch expanding: linear D -> 2D -> 2x2 pixel shuffle -> LN(D/2)."""
    x = _dense(x, {"w": p["w_only"]}, policy)
    return _layer_norm(_shuffle_up(x, 2), p["ln"])


def _final_expand(p, x, policy: Policy):
    """4x expand keeping D: linear D -> 16D -> 4x4 pixel shuffle -> LN."""
    x = _dense(x, {"w": p["w_only"]}, policy)
    return _layer_norm(_shuffle_up(x, 4), p["ln"])


# ---------------------------------------------------------------------------
# Swin-Unet backbone
# ---------------------------------------------------------------------------

PATCH = 4


def _stem_init(gen, in_channels, out_dim, dtype):
    return {"w": _kaiming_normal(gen, (3, 3, in_channels, out_dim),
                                 9 * in_channels, dtype),
            "ln": _ln_init(out_dim, dtype)}


def _embed_init(gen, in_channels, patch, dim, dtype):
    return {"w": _trunc_normal(gen, (patch, patch, in_channels, dim),
                               dtype=dtype),
            "b": torch.zeros((dim,), dtype=dtype),
            "ln": _ln_init(dim, dtype)}


def _up_init(gen, dim, dtype):
    return {"w_only": _trunc_normal(gen, (2 * dim, 4 * dim), dtype=dtype),
            "ln": _ln_init(dim, dtype)}


def _final_init(gen, dim, dtype):
    return {"w_only": _trunc_normal(gen, (dim, 16 * dim), dtype=dtype),
            "ln": _ln_init(dim, dtype)}


def swin_unet_init(gen: torch.Generator, in_channels: int, *,
                   embed_dim: int = 96, depths=(2, 2, 2, 2),
                   heads=(3, 6, 12, 24), window: int = 7,
                   mlp_ratio: int = 4, out_dim: int = 64,
                   dtype=torch.float32):
    """Params of one Swin-Unet, on the CPU, drawn from ``gen`` in a fixed
    order. The heads and the window are read back off the parameter shapes
    at apply time, so there is no state."""
    dims = [embed_dim * (2 ** i) for i in range(4)]
    p = {"stem": _stem_init(gen, in_channels, out_dim, dtype),
         "embed": _embed_init(gen, in_channels, PATCH, dims[0], dtype)}
    for i in range(3):                                    # encoder stages
        p[f"enc{i}"] = [_block_init(gen, dims[i], heads[i], window,
                                    mlp_ratio, dtype)
                        for _ in range(depths[i])]
        p[f"merge{i}"] = {"ln": _ln_init(4 * dims[i], dtype),
                          "w_only": _trunc_normal(
                              gen, (4 * dims[i], 2 * dims[i]), dtype=dtype)}
    p["bott"] = [_block_init(gen, dims[3], heads[3], window, mlp_ratio,
                             dtype) for _ in range(depths[3])]
    for i in (2, 1, 0):                                   # decoder stages
        p[f"up{i}"] = _up_init(gen, dims[i], dtype)
        p[f"fuse{i}"] = _linear_init(gen, 2 * dims[i], dims[i], bias=False,
                                     dtype=dtype)
        p[f"dec{i}"] = [_block_init(gen, dims[i], heads[i], window,
                                    mlp_ratio, dtype)
                        for _ in range(depths[i])]
    p["final"] = _final_init(gen, dims[0], dtype)
    p["out"] = _linear_init(gen, dims[0], out_dim, dtype=dtype)
    return p


def _geometry(params):
    """(heads per stage, window) read off the rpb tables."""
    rpb0 = params["enc0"][0]["attn"]["rpb"]
    window = (int(round(np.sqrt(rpb0.shape[0]))) + 1) // 2
    heads = tuple(params[k][0]["attn"]["rpb"].shape[1]
                  for k in ("enc0", "enc1", "enc2", "bott"))
    return heads, window


def _decode(params, e, skips, policy: Policy, stage):
    """up{i} -> concat(skip_i, up) -> fuse{i} -> stage(dec{i}) for i = 2,
    1, 0, then the final 4x expand and the 64-channel projection."""
    for i in (2, 1, 0):
        e = _expand(params[f"up{i}"], e, policy)
        e = _dense(torch.cat([skips[i], e], dim=-1), params[f"fuse{i}"],
                   policy)
        e = stage(i, e)
    e = _final_expand(params["final"], e, policy)
    return _dense(e, params["out"], policy)


def swin_unet_apply(params, x, *, policy: Policy = DEFAULT):
    """x [N, H, W, Cin] -> (loc [N, H, W, 64], glob [N, H, W, 64])."""
    heads, window = _geometry(params)
    n, h, w, _ = x.shape
    if h % (PATCH * 8) or w % (PATCH * 8):
        raise ValueError(f"input {h}x{w} must be divisible by {PATCH * 8}")
    for s in range(4):
        side = h // PATCH // (2 ** s)
        if side < window or side % window:
            raise ValueError(f"stage {s} feature side {side} not divisible "
                             f"by window {window}; pick the swin window "
                             "accordingly (7 fits 224^2, 8 fits 512^2)")
    xc = policy.cast_compute(x)
    loc = _stem(params["stem"], xc, policy)
    e = _patch_embed(params["embed"], xc, PATCH, policy)

    skips = []
    for i in range(3):
        e = _stage(params[f"enc{i}"], e, heads=heads[i], window=window,
                   policy=policy)
        skips.append(e)
        e = _merge(params[f"merge{i}"], e, policy)
    e = _stage(params["bott"], e, heads=heads[3], window=window,
               policy=policy)
    glob = _decode(params, e, skips, policy,
                   lambda i, e: _stage(params[f"dec{i}"], e, heads=heads[i],
                                       window=window, policy=policy))
    return loc, glob


# ---------------------------------------------------------------------------
# Onet container
# ---------------------------------------------------------------------------

def twin_init(unet_init, gen, weight_share, device):
    """(params, state) of the Onet container of a stateless backbone: one
    net ({"top"}) or two drawn one after the other ({"top", "down"}), moved
    to ``device``; the state is one empty dict per branch (LayerNorm keeps
    no running statistics), shaped like the vanilla state so drivers and
    checkpoints treat it alike."""
    dev = resolve_device(device)
    params = ({"top": unet_init(gen)} if weight_share else
              {"top": unet_init(gen), "down": unet_init(gen)})
    return (tree_map(lambda t: t.to(dev), params),
            {k: {} for k in params})


def swin_onet_init(gen: torch.Generator, in_channels: int = 3, *,
                   weight_share: bool = True, window: int = 7,
                   embed_dim: int = 96, dtype=torch.float32, device=None):
    """(params, state) on ``device`` (default: the card)."""
    return twin_init(
        lambda g: swin_unet_init(g, in_channels, window=window,
                                 embed_dim=embed_dim, dtype=dtype),
        gen, weight_share, device)


def swin_onet_forward(params, state, x, *, train: bool = False,
                      bias: float = 0.0, policy: Policy = DEFAULT, ops=None,
                      channel_stack=None, pair_pack=None):
    """The Onet forward with the Swin-Unet backbone; its signature is
    ``models/onet.py::onet_forward``'s, whose conv-backbone options are
    accepted and unused."""
    del train, ops, channel_stack, pair_pack
    return stateless_onet_forward(swin_unet_apply, params, state, x,
                                  bias=bias, policy=policy)
