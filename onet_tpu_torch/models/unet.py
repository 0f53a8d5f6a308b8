"""U-Net parameters, init subset (``onet_tpu/models/unet.py``).

Channels 64-128-256-512-1024 at ``base=64`` (the reference's 31.04M-param
net); DoubleConv = (3x3 conv no-bias -> BN -> ReLU) x2, Down = maxpool +
DoubleConv, Up = ConvTranspose(k=2, s=2) -> pad -> concat(skip, up) ->
DoubleConv. Parameters are nested dicts with the JAX tree's keys.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.models import layers as L


def _channels(base: int = 64):
    return tuple(base * m for m in (1, 2, 4, 8, 16))


def _double_conv_init(gen, cin, cout, dtype):
    p1, s1 = L.bn_init(cout, dtype)
    p2, s2 = L.bn_init(cout, dtype)
    params = {
        "conv1": {"w": L.kaiming_normal_conv(gen, 3, 3, cin, cout, dtype)},
        "bn1": p1,
        "conv2": {"w": L.kaiming_normal_conv(gen, 3, 3, cout, cout, dtype)},
        "bn2": p2,
    }
    return params, {"bn1": s1, "bn2": s2}


def _up_init(gen, cin, cout, dtype):
    w, b = L.torch_default_convT(gen, 2, 2, cin, cin // 2, dtype)
    conv_p, conv_s = _double_conv_init(gen, cin, cout, dtype)
    return {"up": {"w": w, "b": b}, "conv": conv_p}, {"conv": conv_s}


def unet_init(gen: torch.Generator, in_channels: int = 1,
              dtype=torch.float32, *, base: int = 64):
    """(params, state) dicts for one U-Net, drawn on the CPU from ``gen``
    in a fixed order. ``base`` scales every stage width."""
    c = _channels(base)
    params, state = {}, {}
    params["inc"], state["inc"] = _double_conv_init(gen, in_channels, c[0],
                                                    dtype)
    for i in range(4):
        params[f"down{i + 1}"], state[f"down{i + 1}"] = _double_conv_init(
            gen, c[i], c[i + 1], dtype)
    ups_in = (c[4], c[3], c[2], c[1])
    ups_out = (c[3], c[2], c[1], c[0])
    for i in range(4):
        params[f"up{i + 1}"], state[f"up{i + 1}"] = _up_init(
            gen, ups_in[i], ups_out[i], dtype)
    return params, state


def tree_leaves(tree):
    """Leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))
