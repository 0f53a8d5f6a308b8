"""BN-folded inference path (``onet_tpu/models/infer.py``).

In eval mode BatchNorm is a per-channel affine with frozen statistics, so
it folds into the preceding conv: w' = w * s, b' = beta - mean * s with
s = gamma / sqrt(var + eps). The folded graph is conv + bias -> ReLU.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.policy import Policy, BF16_COMPUTE
from onet_tpu_torch.models.layers import (
    BN_EPS, max_pool_2x2, conv_transpose_2x2, relu, bd2, bd2_skip_up,
    interleave_branches, restack_branches, conv3x3)
from onet_tpu_torch.models.onet import channel_dot, is_weight_shared
from onet_tpu_torch.models.unet import pad_to
from onet_tpu_torch.ops.normalize import complement


def _fold_dconv(p, s):
    def fold(conv_w, bn_p, bn_s):
        scale = bn_p["scale"] / torch.sqrt(bn_s["var"] + BN_EPS)
        return {"w": conv_w * scale, "b": bn_p["bias"] - bn_s["mean"] * scale}

    return {
        "conv1": fold(p["conv1"]["w"], p["bn1"], s["bn1"]),
        "conv2": fold(p["conv2"]["w"], p["bn2"], s["bn2"]),
    }


def fold_unet(params, state):
    out = {"inc": _fold_dconv(params["inc"], state["inc"])}
    for i in range(1, 5):
        out[f"down{i}"] = _fold_dconv(params[f"down{i}"], state[f"down{i}"])
    for i in range(1, 5):
        out[f"up{i}"] = {
            "up": params[f"up{i}"]["up"],
            "conv": _fold_dconv(params[f"up{i}"]["conv"],
                                state[f"up{i}"]["conv"]),
        }
    return out


def fold_onet(params, state):
    folded = {"top": fold_unet(params["top"], state["top"])}
    if not is_weight_shared(params):
        folded["down"] = fold_unet(params["down"], state["down"])
    return folded


def _conv_bias_relu(x, pc, policy):
    y = conv3x3(x, pc["w"], policy=policy)
    return relu(y + pc["b"].to(y.dtype))


def _dconv_infer(p, x, policy):
    return _conv_bias_relu(_conv_bias_relu(x, p["conv1"], policy),
                           p["conv2"], policy)


def _decode(fp, feats, policy, levels):
    """Decoder levels up1..up{levels}: convT, pad, concat(skip, up), dconv."""
    y = feats[-1]
    for i in range(1, levels + 1):
        up = fp[f"up{i}"]["up"]
        y = conv_transpose_2x2(y, up["w"], up["b"], policy=policy)
        skip = feats[4 - i]
        y = _dconv_infer(fp[f"up{i}"]["conv"],
                         torch.cat([skip, pad_to(y, skip)], dim=-1), policy)
    return y


def _mid(fp, xb, policy):
    """Batch-stacked [2B, ...] mid-network from down1.conv2 to up3: the part
    shared by the stacked and pair-packed paths."""
    feats = [None, _conv_bias_relu(xb, fp["down1"]["conv2"], policy)]
    for i in range(2, 5):
        feats.append(_dconv_infer(fp[f"down{i}"], max_pool_2x2(feats[-1]),
                                  policy))
    return _decode(fp, feats, policy, levels=3)


def unet_infer(fp, x, *, policy: Policy = BF16_COMPUTE):
    x1 = _dconv_infer(fp["inc"], x, policy)
    feats = [x1]
    for i in range(1, 5):
        feats.append(_dconv_infer(fp[f"down{i}"], max_pool_2x2(feats[-1]),
                                  policy))
    return x1, _decode(fp, feats, policy, levels=4)


def _cbr_stacked(x, pc, policy, *, wmap=bd2):
    """conv + tiled bias + relu on a channel-stacked pair; the bias is added
    in the compute dtype."""
    y = conv3x3(x, wmap(pc["w"]), policy=policy)
    return relu(y + pc["b"].repeat(2).to(y.dtype))


def unet_infer_stacked(fp, x, *, policy: Policy = BF16_COMPUTE,
                       dp_local: bool = False):
    """Folded forward with the branches channel-stacked at the 64-channel
    levels. ``x`` is [B, H, W, 2*cin]; returns stacked (local, glob)
    [B, H, W, 128]. ``dp_local=True`` unstacks and restacks the branches
    interleaved by sample instead of in two batch blocks."""
    b = x.shape[0]
    h = _cbr_stacked(x, fp["inc"]["conv1"], policy)
    x1s = _cbr_stacked(h, fp["inc"]["conv2"], policy)
    c = x1s.shape[-1] // 2
    h = _cbr_stacked(max_pool_2x2(x1s), fp["down1"]["conv1"], policy)
    if dp_local:
        xb = interleave_branches(h)
    else:
        c1 = h.shape[-1] // 2
        xb = torch.cat([h[..., :c1], h[..., c1:]], dim=0)
    y = _mid(fp, xb, policy)
    y2s = restack_branches(y) if dp_local else torch.cat([y[:b], y[b:]],
                                                         dim=-1)
    up = fp["up4"]["up"]
    u = conv_transpose_2x2(y2s, bd2(up["w"]), up["b"].repeat(2),
                           policy=policy)
    xin = torch.cat([x1s, pad_to(u, x1s)], dim=-1)            # [s1|s2|u1|u2]
    pc = fp["up4"]["conv"]
    h = _cbr_stacked(xin, pc["conv1"], policy,
                     wmap=lambda w: bd2_skip_up(w, c_skip=c))
    return x1s, _cbr_stacked(h, pc["conv2"], policy)


def onet_infer(folded, x, *, bias: float = 0.0,
               policy: Policy = BF16_COMPUTE, channel_stack: bool = None,
               pair_pack: bool = None, dp_local: bool = False):
    """Folded forward -> (S [B, H, W, 2] f32, labels [B, H, W]).

    Branches, as in the JAX package: the pair-packed kernels (weight-shared,
    ``pair_pack`` and ``wp_supported``), else channel-stacked
    (weight-shared and ``channel_stack``), else batch-stacked
    (weight-shared), else the twin nets one after the other."""
    from onet_tpu_torch.models import onet as O

    with policy.precision():
        xd = complement(x, bias)
        stack = O.CHANNEL_STACK if channel_stack is None else channel_stack
        wp = O.PAIR_PACK if pair_pack is None else pair_pack
        if "down" not in folded and wp:
            from onet_tpu_torch.models.wp import (
                unet_infer_wp, head_wp, wp_supported)
            base = folded["top"]["inc"]["conv1"]["w"].shape[-1]
            if wp_supported(x.shape, base):
                xx = torch.cat([x, xd], dim=-1)
                loc_wp, glob_wp = unet_infer_wp(folded["top"], xx,
                                                policy=policy)
                v, _ = head_wp(loc_wp, glob_wp)
                s = torch.softmax(v, dim=-1)
                return s, torch.argmax(s, dim=-1)
        if "down" not in folded and stack:
            xx = torch.cat([x, xd], dim=-1)
            loc, glob = unet_infer_stacked(folded["top"], xx, policy=policy,
                                           dp_local=dp_local)
            v, _ = O.stacked_head(loc, glob)
            s = torch.softmax(v, dim=-1)
            return s, torch.argmax(s, dim=-1)
        if "down" not in folded:
            xx = torch.cat([x, xd], dim=0)
            loc, glob = unet_infer(folded["top"], xx, policy=policy)
            b = x.shape[0]
            lt, ld = loc[:b], loc[b:]
            ht, hd = glob[:b], glob[b:]
        else:
            lt, ht = unet_infer(folded["top"], x, policy=policy)
            ld, hd = unet_infer(folded["down"], xd, policy=policy)
        vt = channel_dot(lt.float(), ht.float())
        vd = channel_dot(ld.float(), hd.float())
        s = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
        return s, torch.argmax(s, dim=-1)
