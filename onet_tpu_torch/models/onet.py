"""Onet: twin (optionally weight-shared) U-Nets with the JSD head
(``onet_tpu/models/onet.py``).

The complementary input X_d = clip(1 - X + bias, 0, 1); the per-pixel
projection V_i = <L_i, H_i> and S = softmax([V_t, V_d]); the JSD lower bound
-mean(log1pexp(-<L,S>)) - mean(log1pexp(<L,S'>)) per branch and the
symmetric loss -(jsd_top + jsd_dwn)/2. ``channel_dot`` keeps the
reference's einsum broadcast quirk, so the JSD inner product is S times
the channel sum of L.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models.unet import (
    unet_init, unet_apply, unet_apply_stacked, tree_map)
from onet_tpu_torch.ops.math import log1pexp
from onet_tpu_torch.ops.normalize import complement

# Weight-shared twin pass layout: channel-stack the complementary branches
# at the 64-channel levels (models/infer.py::unet_infer_stacked).
CHANNEL_STACK = True

# Width-pair-packed 512^2 levels on the hand-written conv kernels
# (models/wp.py); applies only where wp_supported() holds.
PAIR_PACK = False


class OnetOutput(NamedTuple):
    Lt: torch.Tensor   # [B, H, W, 64] local features, top branch
    Ld: torch.Tensor   # [B, H, W, 64] local features, down branch
    Vt: torch.Tensor   # [B, H, W] projection logits, top
    Vd: torch.Tensor   # [B, H, W] projection logits, down
    S: torch.Tensor    # [B, H, W, 2] class probabilities
    # channel-summed local features [B, H, W, 2] (top, down), where the
    # path computes them with the head; the JSD loss then reads only these
    Lsum: torch.Tensor = None


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


def onet_forward(params, state, x, *, train: bool, bias: float = 0.0,
                 policy: Policy = DEFAULT, channel_stack: bool = None,
                 pair_pack: bool = None, dp_local: bool = False):
    """Forward pass on an NHWC batch in [0, 1]; returns (OnetOutput,
    new_state). Branches, as in the JAX package: the pair-packed kernels
    (weight-shared, ``pair_pack`` and ``wp_supported``), else
    channel-stacked (weight-shared and ``channel_stack``; ``dp_local``
    interleaves its middle levels by sample), else batch-stacked
    (weight-shared), else the twin nets one after the other."""
    xd = complement(x, bias)
    stack = CHANNEL_STACK if channel_stack is None else channel_stack
    wp = PAIR_PACK if pair_pack is None else pair_pack
    b = x.shape[0]
    if is_weight_shared(params) and wp:
        from onet_tpu_torch.models.wp import (
            unet_apply_wp, head_wp, wp_supported)
        base = params["top"]["inc"]["conv1"]["w"].shape[-1]
        if wp_supported(x.shape, base):
            xx = torch.cat([x, xd], dim=-1)
            (loc_wp, glob_wp), new_top = unet_apply_wp(
                params["top"], state["top"], xx, train=train, policy=policy)
            v, lsum = head_wp(loc_wp, glob_wp)
            n, h, wpc, _ = loc_wp.shape
            return OnetOutput(
                Lt=loc_wp[:b].reshape(b, h, 2 * wpc, 64),
                Ld=loc_wp[b:].reshape(b, h, 2 * wpc, 64),
                Vt=v[..., 0], Vd=v[..., 1], S=torch.softmax(v, dim=-1),
                Lsum=lsum), {"top": new_top}
    if is_weight_shared(params) and stack:
        xx = torch.cat([x, xd], dim=-1)
        (loc, glob), new_top = unet_apply_stacked(
            params["top"], state["top"], xx, train=train, policy=policy,
            dp_local=dp_local)
        c = loc.shape[-1] // 2
        v, lsum = stacked_head(loc, glob)
        return OnetOutput(Lt=loc[..., :c], Ld=loc[..., c:], Vt=v[..., 0],
                          Vd=v[..., 1], S=torch.softmax(v, dim=-1),
                          Lsum=lsum), {"top": new_top}
    if is_weight_shared(params):
        xx = torch.cat([x, xd], dim=0)
        (loc, glob), new_top = unet_apply(params["top"], state["top"], xx,
                                          train=train, groups=2,
                                          policy=policy)
        lt, ld, ht, hd = loc[:b], loc[b:], glob[:b], glob[b:]
        new_state = {"top": new_top}
    else:
        (lt, ht), new_top = unet_apply(params["top"], state["top"], x,
                                       train=train, groups=1, policy=policy)
        (ld, hd), new_dwn = unet_apply(params["down"], state["down"], xd,
                                       train=train, groups=1, policy=policy)
        new_state = {"top": new_top, "down": new_dwn}
    vt = channel_dot(lt.float(), ht.float())
    vd = channel_dot(ld.float(), hd.float())
    s = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
    return OnetOutput(Lt=lt, Ld=ld, Vt=vt, Vd=vd, S=s), new_state


def predict_label(s: torch.Tensor) -> torch.Tensor:
    """argmax over the class pair: 0 = top wins, 1 = down wins. [B, H, W]."""
    return torch.argmax(s, dim=-1)


def get_label(vt: torch.Tensor, vd: torch.Tensor):
    """Re-softmax raw projection maps into (labels, probabilities)."""
    s = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
    return torch.argmax(s, dim=-1), s


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def jsd(l_sum: torch.Tensor, s_self: torch.Tensor,
        s_other: torch.Tensor) -> torch.Tensor:
    """JSD lower bound of one branch: l_sum the channel-summed local
    features [B, H, W], s_self / s_other this / the other branch's
    probabilities [B, H, W]."""
    return (-torch.mean(log1pexp(-l_sum * s_self))
            - torch.mean(log1pexp(l_sum * s_other)))


class _JsdLossPair(torch.autograd.Function):
    """-(jsd_top + jsd_dwn)/2 on the pair tensors (Lsum, S), [B, H, W, 2].
    The backward is the JAX package's hand-written one: it saves only
    (Lsum, S) and uses sigmoid for the derivative of log1pexp (the
    piecewise branches differ from sigmoid by < 1e-30 where they diverge);
    it is not autograd of the piecewise form."""

    @staticmethod
    def forward(ctx, lsum, s):
        lt, ld = lsum[..., 0], lsum[..., 1]
        st, sd = s[..., 0], s[..., 1]
        ctx.save_for_backward(lsum, s)
        return (torch.mean(log1pexp(-lt * st)) + torch.mean(log1pexp(lt * sd))
                + torch.mean(log1pexp(-ld * sd))
                + torch.mean(log1pexp(ld * st))) / 2.0

    @staticmethod
    def backward(ctx, g):
        lsum, s = ctx.saved_tensors
        lt, ld = lsum[..., 0], lsum[..., 1]
        st, sd = s[..., 0], s[..., 1]
        k = g / (2.0 * lt.numel())
        sig_a = torch.sigmoid(-lt * st)
        sig_b = torch.sigmoid(lt * sd)
        sig_c = torch.sigmoid(-ld * sd)
        sig_d = torch.sigmoid(ld * st)
        dlsum = torch.stack([k * (-sig_a * st + sig_b * sd),
                             k * (-sig_c * sd + sig_d * st)], dim=-1)
        ds = torch.stack([k * (-sig_a * lt + sig_d * ld),
                          k * (sig_b * lt - sig_c * ld)], dim=-1)
        return dlsum, ds


def jsd_loss_pair(lsum: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return _JsdLossPair.apply(lsum, s)


def compute_loss(out: OnetOutput) -> torch.Tensor:
    """Symmetric JSD loss, f32: the pair form where the head computed
    Lsum, the reference's per-branch form otherwise."""
    if out.Lsum is not None:
        return jsd_loss_pair(out.Lsum, out.S)
    ct = torch.sum(out.Lt.float(), dim=-1)
    cd = torch.sum(out.Ld.float(), dim=-1)
    st, sd = out.S[..., 0], out.S[..., 1]
    return -(jsd(ct, st, sd) + jsd(cd, sd, st)) / 2.0


def compute_loss_rsn(out: OnetOutput) -> torch.Tensor:
    """Random-sampling-negative ablation: each branch's negative score map
    comes from another image of the batch (a roll by one) instead of the
    complement branch's. Needs batch >= 2."""
    if out.S.shape[0] < 2:
        raise ValueError("RSN loss needs batch >= 2 (in-batch negatives)")
    if out.Lsum is not None:
        lt, ld = out.Lsum[..., 0], out.Lsum[..., 1]
    else:
        lt = torch.sum(out.Lt.float(), dim=-1)
        ld = torch.sum(out.Ld.float(), dim=-1)
    st, sd = out.S[..., 0], out.S[..., 1]
    return -(jsd(lt, st, torch.roll(st, 1, dims=0))
             + jsd(ld, sd, torch.roll(sd, 1, dims=0))) / 2.0


LOSSES = {"jsd": compute_loss, "rsn": compute_loss_rsn}
