"""Functional U-Net returning (local, global) features
(``onet_tpu/models/unet.py``).

Channels 64-128-256-512-1024 at ``base=64`` (the reference's 31.04M-param
net); DoubleConv = (3x3 conv no-bias -> BN -> ReLU) x2, Down = maxpool +
DoubleConv, Up = ConvTranspose(k=2, s=2) -> pad -> concat(skip, up) ->
DoubleConv. Parameters are nested dicts with the JAX tree's keys. The
forward returns the first DoubleConv's output (local features) and the
last decoder output (global features), with the new BatchNorm state.

``ops`` is the injection point of the layer primitives (``DEFAULT_OPS``:
conv3x3, batch_norm, max_pool, conv_transpose); the int8 trainer
(``models/qtrain.py``) substitutes its conv, the spatial trainer its
halo-exchange ops (``parallel/halo.py::make_halo_ops``). The JAX
package's ``reshard`` argument (GSPMD sharding hooks) has no counterpart:
the port's parallel trainers move data with explicit collectives
(``parallel/``), so there is no sharding to pin.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import layers as L

# Injectable layer primitives: the default runs the exact layers; the int8
# trainer (models/qtrain.py::make_qtrain_ops) substitutes the conv.
DEFAULT_OPS = types.SimpleNamespace(
    conv3x3=L.conv3x3,
    batch_norm=L.batch_norm,
    max_pool=L.max_pool_2x2,
    conv_transpose=L.conv_transpose_2x2,
)


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


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _double_conv(params, state, x, *, train, groups, policy,
                 ops=DEFAULT_OPS, interleaved=False):
    x = ops.conv3x3(x, params["conv1"]["w"], policy=policy)
    x, s1 = ops.batch_norm(x, params["bn1"], state["bn1"], train=train,
                           groups=groups, interleaved=interleaved)
    x = L.relu(x)
    x = ops.conv3x3(x, params["conv2"]["w"], policy=policy)
    x, s2 = ops.batch_norm(x, params["bn2"], state["bn2"], train=train,
                           groups=groups, interleaved=interleaved)
    return L.relu(x), {"bn1": s1, "bn2": s2}


def _down(params, state, x, *, train, groups, policy, ops=DEFAULT_OPS,
          interleaved=False):
    return _double_conv(params, state, ops.max_pool(x), train=train,
                        groups=groups, policy=policy, ops=ops,
                        interleaved=interleaved)


def pad_to(y, ref):
    """The decoder pad of odd sizes: centre y on ref's spatial size (the
    reference's asymmetric F.pad)."""
    dh = ref.shape[1] - y.shape[1]
    dw = ref.shape[2] - y.shape[2]
    if dh or dw:
        y = F.pad(y, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return y


def _up(params, state, x, skip, *, train, groups, policy, ops=DEFAULT_OPS,
        interleaved=False):
    x = ops.conv_transpose(x, params["up"]["w"], params["up"]["b"],
                           policy=policy)
    x = torch.cat([skip, pad_to(x, skip)], dim=-1)    # reference: [skip, up]
    y, s = _double_conv(params["conv"], state["conv"], x, train=train,
                        groups=groups, policy=policy, ops=ops,
                        interleaved=interleaved)
    return y, {"conv": s}


def _mid_levels(params, state, x2, new_state, *, train, policy,
                interleaved, ops=DEFAULT_OPS):
    """down2 .. up3 on the batch-stacked [2B, ...] tensor: shared by the
    stacked and pair-packed paths. Fills ``new_state``; returns y2."""
    kw = dict(train=train, groups=2, policy=policy, ops=ops,
              interleaved=interleaved)
    x3, new_state["down2"] = _down(params["down2"], state["down2"], x2, **kw)
    x4, new_state["down3"] = _down(params["down3"], state["down3"], x3, **kw)
    x5, new_state["down4"] = _down(params["down4"], state["down4"], x4, **kw)
    y4, new_state["up1"] = _up(params["up1"], state["up1"], x5, x4, **kw)
    y3, new_state["up2"] = _up(params["up2"], state["up2"], y4, x3, **kw)
    y2, new_state["up3"] = _up(params["up3"], state["up3"], y3, x2, **kw)
    return y2


def down1_stacked(p, s, hp, *, train, policy, interleaved,
                  ops=DEFAULT_OPS):
    """down1 from the channel-stacked pooled tensor: conv1 channel-stacked
    (block-diagonal weight), then the unstack to the batch form (block
    concat, or sample interleave with ``interleaved``) and conv2 there.
    Returns (x2 [2B, ...], down1 state)."""
    h = ops.conv3x3(hp, L.bd2(p["conv1"]["w"]), policy=policy)
    h, s1 = ops.batch_norm(h, p["bn1"], s["bn1"], train=train, groups=2,
                           stacked=True)
    h = L.relu(h)
    if interleaved:
        xb = L.interleave_branches(h)
    else:
        c1 = h.shape[-1] // 2
        xb = torch.cat([h[..., :c1], h[..., c1:]], dim=0)
    xb = ops.conv3x3(xb, p["conv2"]["w"], policy=policy)
    xb, s2 = ops.batch_norm(xb, p["bn2"], s["bn2"], train=train, groups=2,
                            interleaved=interleaved)
    return L.relu(xb), {"bn1": s1, "bn2": s2}


def unet_apply_stacked(params, state, x, *, train: bool,
                       policy: Policy = DEFAULT, ops=DEFAULT_OPS,
                       dp_local: bool = False):
    """Weight-shared twin pass with the branches channel-stacked at the
    64-channel levels (inc, up4; block-diagonal weights) and batch-stacked
    in between. ``x`` is [B, H, W, 2*in_ch]; ``dp_local=True`` unstacks
    the middle levels sample-interleaved instead of in two batch blocks.
    Returns ((local, glob), new_state), local/glob [B, H, W, 128]."""
    new_state = {}
    b = x.shape[0]
    p, s = params["inc"], state["inc"]
    h = ops.conv3x3(x, L.bd2(p["conv1"]["w"]), policy=policy)
    h, s1 = ops.batch_norm(h, p["bn1"], s["bn1"], train=train, groups=2,
                           stacked=True)
    h = L.relu(h)
    h = ops.conv3x3(h, L.bd2(p["conv2"]["w"]), policy=policy)
    h, s2 = ops.batch_norm(h, p["bn2"], s["bn2"], train=train, groups=2,
                           stacked=True)
    x1s = L.relu(h)
    new_state["inc"] = {"bn1": s1, "bn2": s2}

    c = x1s.shape[-1] // 2
    x2, new_state["down1"] = down1_stacked(
        params["down1"], state["down1"], ops.max_pool(x1s), train=train,
        policy=policy, interleaved=dp_local, ops=ops)
    y2 = _mid_levels(params, state, x2, new_state, train=train,
                     policy=policy, interleaved=dp_local, ops=ops)
    y2s = (L.restack_branches(y2) if dp_local
           else torch.cat([y2[:b], y2[b:]], dim=-1))
    up, sc = params["up4"], state["up4"]["conv"]
    u = ops.conv_transpose(y2s, L.bd2(up["up"]["w"]),
                           up["up"]["b"].repeat(2), policy=policy)
    xin = torch.cat([x1s, pad_to(u, x1s)], dim=-1)      # [s1|s2|u1|u2]
    pc = up["conv"]
    h = ops.conv3x3(xin, L.bd2_skip_up(pc["conv1"]["w"], c_skip=c),
                    policy=policy)
    h, s1 = ops.batch_norm(h, pc["bn1"], sc["bn1"], train=train, groups=2,
                           stacked=True)
    h = L.relu(h)
    h = ops.conv3x3(h, L.bd2(pc["conv2"]["w"]), policy=policy)
    h, s2 = ops.batch_norm(h, pc["bn2"], sc["bn2"], train=train, groups=2,
                           stacked=True)
    new_state["up4"] = {"conv": {"bn1": s1, "bn2": s2}}
    return (x1s, L.relu(h)), new_state


def unet_apply(params, state, x, *, train: bool, groups: int = 1,
               policy: Policy = DEFAULT, ops=DEFAULT_OPS):
    """The U-Net on an NHWC batch of ``groups`` stacked branches. Returns
    ((local, glob), new_state), each feature [N, H, W, base]."""
    new_state = {}
    kw = dict(train=train, groups=groups, policy=policy, ops=ops)
    x1, new_state["inc"] = _double_conv(params["inc"], state["inc"], x, **kw)
    x2, new_state["down1"] = _down(params["down1"], state["down1"], x1, **kw)
    x3, new_state["down2"] = _down(params["down2"], state["down2"], x2, **kw)
    x4, new_state["down3"] = _down(params["down3"], state["down3"], x3, **kw)
    x5, new_state["down4"] = _down(params["down4"], state["down4"], x4, **kw)
    y4, new_state["up1"] = _up(params["up1"], state["up1"], x5, x4, **kw)
    y3, new_state["up2"] = _up(params["up2"], state["up2"], y4, x3, **kw)
    y2, new_state["up3"] = _up(params["up3"], state["up3"], y3, x2, **kw)
    y1, new_state["up4"] = _up(params["up4"], state["up4"], y2, x1, **kw)
    return (x1, y1), new_state


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    """Leaves of a nested tree of dicts and lists: dict keys in sorted
    order, list elements in index order (the JAX package's leaf order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested tree of dicts and lists
    (leaf by leaf across ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))
