"""Width-pair-packed path (``onet_tpu/models/wp.py``): the 512^2-scale
levels of the weight-shared U-Net on the hand-written pair-packed kernels
(ops/conv_wp.py), training and serving.

Training forward (``unet_apply_wp``), weight-shared twin, input [B, H, W, cin]:

  inc.conv1 + bn1 + relu    cuDNN, channel-stacked    [B, H, W, 128]
  pack_wp                   one relayout              [2B, H, W/2, 128]
  inc.conv2 (+BN stats)     KERNEL conv3x3_wp         stays packed
  bn2 apply + relu          elementwise, full BN backward (_BnApplyWp)
  pool_wp                   packed -> channel-stacked [B, H/2, W/2, 128]
  down1 .. up3              the stacked path of models/unet.py
  up4.up (convT)            f32-accumulated matmul, EMITS packed
  up4.conv1 (+BN stats)     KERNEL conv3x3_wp2 (skip, up), no concat
  up4.conv2 (+BN stats)     KERNEL conv3x3_wp
  head_wp                   packed reductions -> [B, H, W, 2]

The backward of each kernel site runs the forward kernel for dx and
``conv3x3_wp_dw`` for dw. BatchNorm batch statistics come from the conv
kernels' fused epilogue (per-sample lane sums), so no pass re-reads the
512^2 conv outputs for them. The serving forward (``unet_infer_wp``) is
BN-folded: bias + ReLU fused into each kernel's store.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import infer as I
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.models import unet as U
from onet_tpu_torch.ops.conv_wp import (
    conv3x3_wp, conv3x3_wp2, conv3x3_wp_raw, conv3x3_wp2_raw, make_wc_we,
    pack_wp)


# ---------------------------------------------------------------------------
# BatchNorm on packed tensors with kernel-precomputed statistics
# ---------------------------------------------------------------------------

def _fold_stats(s1, s2, cnt, axis=None):
    """Per-sample lane sums [N, 128] -> per-branch (mean, var) [2, 64]
    (branch b = batch half b; lanes (parity, channel) fold over parity);
    var = E[x^2] - mean^2 in f32, as the JAX package computes it. Under a
    mesh ``axis`` the folded sums are all-reduced over it first and
    ``cnt`` is the global count."""
    b = s1.shape[0] // 2
    s1f = s1[:, :64] + s1[:, 64:]
    s2f = s2[:, :64] + s2[:, 64:]
    t1 = torch.stack([s1f[:b].sum(0), s1f[b:].sum(0)])
    t2 = torch.stack([s2f[:b].sum(0), s2f[b:].sum(0)])
    if axis is not None:
        t1, t2 = L.all_reduce_sums(axis, t1, t2)
    mean = t1 / cnt
    ex2 = t2 / cnt
    return mean, ex2 - mean.square()


def _per_sample(vec2, b):
    """[2, C'] per-branch vectors -> [2B, 1, 1, C'] per sample."""
    return vec2.repeat_interleave(b, dim=0)[:, None, None, :]


class _BnApplyWp(torch.autograd.Function):
    """Train-mode BN apply on a packed tensor with precomputed per-branch
    statistics (mean, inv = rsqrt(var + eps), each [2, 64]). The backward
    is the full BatchNorm backward, the statistics' dependence on y
    included, as in layers._BnTrainCh; mean and inv get no gradient.
    Under a mesh ``axis`` the backward's two sums are all-reduced over it
    (full-batch statistics have a full-batch gradient)."""

    @staticmethod
    def forward(ctx, y, scale, bias, mean, inv, axis=None):
        b = y.shape[0] // 2
        sf = scale.float()
        a2 = (inv * sf).repeat(1, 2)                               # [2, 128]
        c2 = (bias.float() - mean * inv * sf).repeat(1, 2)
        ctx.save_for_backward(y, scale, mean, inv)
        ctx.axis = axis
        return (y.float() * _per_sample(a2, b)
                + _per_sample(c2, b)).to(y.dtype)

    @staticmethod
    def backward(ctx, dy):
        y, scale, mean, inv = ctx.saved_tensors
        n, h, wp, _ = y.shape
        b = n // 2
        cnt = b * h * wp * 2                  # per-branch count per channel
        axis = ctx.axis
        if axis is not None:
            cnt *= axis.size
        yf, dyf = y.float(), dy.float()
        xhat = ((yf - _per_sample(mean.repeat(1, 2), b))
                * _per_sample(inv.repeat(1, 2), b))
        t_dy = dyf.sum(dim=(1, 2))                                 # [N, 128]
        t_dyx = (dyf * xhat).sum(dim=(1, 2))
        f_dy = t_dy[:, :64] + t_dy[:, 64:]
        f_dyx = t_dyx[:, :64] + t_dyx[:, 64:]
        sum_dy = torch.stack([f_dy[:b].sum(0), f_dy[b:].sum(0)])   # [2, 64]
        sum_dyx = torch.stack([f_dyx[:b].sum(0), f_dyx[b:].sum(0)])
        g_dy, g_dyx = sum_dy, sum_dyx
        if axis is not None:
            g_dy, g_dyx = L.all_reduce_sums(axis, sum_dy, sum_dyx)
        sf = scale.float()
        a_ns = _per_sample((inv * sf).repeat(1, 2), b)
        sd_ns = _per_sample((g_dy / cnt).repeat(1, 2), b)
        sdx_ns = _per_sample((g_dyx / cnt).repeat(1, 2), b)
        dx = (a_ns * (dyf - sd_ns - xhat * sdx_ns)).to(y.dtype)
        return (dx, sum_dyx.sum(0).to(scale.dtype),
                sum_dy.sum(0).to(scale.dtype), None, None, None)


def _bn_wp(y, s1, s2, params, state, *, train, momentum=L.BN_MOMENTUM,
           eps=L.BN_EPS):
    """BatchNorm on a packed conv output from the kernel's fused stats.
    Returns (normalized y, new_state); the running-stats EMA replays the
    reference's order (top branch, then down), as layers.batch_norm."""
    n, h, wp, _ = y.shape
    if not train:
        inv = torch.rsqrt(state["var"] + eps)
        sf = params["scale"].float()
        a2 = (inv * sf).repeat(2)
        c2 = (params["bias"].float() - state["mean"] * inv * sf).repeat(2)
        return (y.float() * a2 + c2).to(y.dtype), state
    axis = L.current_bn_axis()
    cnt = (n // 2) * h * wp * 2 * (1 if axis is None else axis.size)
    mean, var = _fold_stats(s1, s2, cnt, axis)
    inv = torch.rsqrt(var + eps)
    out = _BnApplyWp.apply(y, params["scale"], params["bias"], mean, inv,
                           axis)
    return out, L.ema_update(state, mean, var, cnt, momentum)


# ---------------------------------------------------------------------------
# pool: packed -> channel-stacked, first-match backward
# ---------------------------------------------------------------------------


def _pool_wp_val(x):
    """2x2 max pool on packed [2B, H, Wp, 128], emitting the
    channel-stacked [B, H/2, Wp, 128] tensor the mid-network takes."""
    b = x.shape[0] // 2
    m1 = torch.maximum(x[..., :64], x[..., 64:])     # over column parity
    m2 = torch.maximum(m1[:, ::2], m1[:, 1::2])      # over row pairs
    return torch.cat([m2[:b], m2[b:]], dim=-1)


class _PoolWp(torch.autograd.Function):
    """pool_wp with the JAX package's backward: a window's gradient goes to
    its first maximum in the order (r0,c0), (r0,c1), (r1,c0), (r1,c1),
    c the parity lane block (torch/XLA first-match tie semantics)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _pool_wp_val(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        n, h, wp, l = x.shape
        b = n // 2
        gb = torch.cat([g[..., :64], g[..., 64:]], dim=0).to(x.dtype)
        a, bb = x[:, ::2, :, :64], x[:, ::2, :, 64:]
        c, d = x[:, 1::2, :, :64], x[:, 1::2, :, 64:]
        m = torch.maximum(torch.maximum(a, bb), torch.maximum(c, d))
        ea = a == m
        eb = (bb == m) & ~ea
        ec = (c == m) & ~ea & ~eb
        ed = (d == m) & ~ea & ~eb & ~ec
        z = torch.zeros_like(gb)
        row0 = torch.cat([torch.where(ea, gb, z), torch.where(eb, gb, z)],
                         dim=-1)
        row1 = torch.cat([torch.where(ec, gb, z), torch.where(ed, gb, z)],
                         dim=-1)
        return torch.stack([row0, row1], dim=2).reshape(n, h, wp, l)


def pool_wp(x):
    """2x2 max pool, packed [2B, H, Wp, 128] -> channel-stacked
    [B, H/2, Wp, 128], differentiable with first-match ties."""
    return _PoolWp.apply(x)


def convT_wp(y2s, w, bias, *, policy: Policy = DEFAULT):
    """Kernel-2 stride-2 ConvTranspose on the channel-stacked decoder
    tensor [B, Hs, Ws, 2*cin], emitting the packed [2B, 2Hs, Ws, 128]
    up-tensor: each output row parity di is one [.., cin] x [cin, 2*cout]
    product with lanes (dj, cout). Products of compute-dtype operands
    accumulate in f32 and the bias is added in f32 before the cast."""
    b, hs, ws, c2 = y2s.shape
    cin = c2 // 2
    xb = policy.cast_compute(
        torch.cat([y2s[..., :cin], y2s[..., cin:]], dim=0))
    wdt = policy.cast_compute(w)
    cout = w.shape[-1]
    rows = [xb.float() @ wdt[di].permute(1, 0, 2).reshape(cin, 2 * cout)
            .float() for di in range(2)]
    y = torch.stack(rows, dim=2).reshape(2 * b, 2 * hs, ws, 2 * cout)
    return (y + bias.float().repeat(2)).to(xb.dtype)


def head_wp(loc_wp, glob_wp):
    """(v, lsum), each [B, H, W, 2] f32, from packed features: per-pixel
    64-channel dot and channel sum per branch."""
    n, h, wp, _ = loc_wp.shape
    b = n // 2
    lf = loc_wp.float()
    vpp = (lf * glob_wp.float()).unflatten(-1, (2, 64)).sum(-1)
    lpp = lf.unflatten(-1, (2, 64)).sum(-1)        # [2B, H, Wp, parity]
    v = torch.stack([vpp[:b].reshape(b, h, 2 * wp),
                     vpp[b:].reshape(b, h, 2 * wp)], dim=-1)
    lsum = torch.stack([lpp[:b].reshape(b, h, 2 * wp),
                        lpp[b:].reshape(b, h, 2 * wp)], dim=-1)
    return v, lsum


def unet_apply_wp(params, state, x_stacked, *, train: bool,
                  policy: Policy = DEFAULT):
    """Weight-shared twin pass with the 512^2 levels on the pair-packed
    kernels. ``x_stacked`` is [B, H, W, 2*in_ch] (branch blocks on
    channels). Returns ((loc_wp, glob_wp), new_state), both features
    packed [2B, H, W/2, 128]. Eval mode (``train=False``) normalizes with
    the running statistics; the kernels still emit the batch stats."""
    new_state = {}
    bsz = x_stacked.shape[0]
    cast = policy.cast_compute
    p, s = params["inc"], state["inc"]
    h = L.conv3x3(x_stacked, L.bd2(p["conv1"]["w"]), policy=policy)
    h, s1 = L.batch_norm(h, p["bn1"], s["bn1"], train=train, groups=2,
                         stacked=True)
    hp = pack_wp(cast(L.relu(h)))                    # the one entry relayout

    y, st1, st2 = conv3x3_wp(hp, cast(p["conv2"]["w"]))
    y, s2 = _bn_wp(y, st1, st2, p["bn2"], s["bn2"], train=train)
    x1_wp = L.relu(y)
    new_state["inc"] = {"bn1": s1, "bn2": s2}

    # pool (packed -> channel-stacked) and the unchanged mid-network
    x2, new_state["down1"] = U.down1_stacked(
        params["down1"], state["down1"], pool_wp(x1_wp), train=train,
        policy=policy, interleaved=False)
    y2 = U._mid_levels(params, state, x2, new_state, train=train,
                       policy=policy, interleaved=False)

    # decoder top: convT emits packed; the two-input conv eats (skip, up)
    y2s = torch.cat([y2[:bsz], y2[bsz:]], dim=-1)
    up, sc = params["up4"], state["up4"]["conv"]
    u_wp = convT_wp(y2s, up["up"]["w"], up["up"]["b"], policy=policy)
    pc = up["conv"]
    wc1 = pc["conv1"]["w"]
    ya, sa1, sa2 = conv3x3_wp2(x1_wp, u_wp, cast(wc1[:, :, :64]),
                               cast(wc1[:, :, 64:]))
    ya, su1 = _bn_wp(ya, sa1, sa2, pc["bn1"], sc["bn1"], train=train)
    yb, sb1, sb2 = conv3x3_wp(L.relu(ya), cast(pc["conv2"]["w"]))
    yb, su2 = _bn_wp(yb, sb1, sb2, pc["bn2"], sc["bn2"], train=train)
    new_state["up4"] = {"conv": {"bn1": su1, "bn2": su2}}
    return (x1_wp, L.relu(yb)), new_state


def unet_infer_wp(fp, x_stacked, *, policy: Policy):
    """BN-folded serving forward with the 512^2 levels on the pair-packed
    kernels, bias + ReLU fused into each kernel's store. Returns packed
    (loc_wp, glob_wp)."""
    bsz = x_stacked.shape[0]
    h = I._cbr_stacked(x_stacked, fp["inc"]["conv1"], policy)
    hp = pack_wp(policy.cast_compute(h))
    dt = hp.dtype

    def cbr_wp(xp, site):
        wc, we = make_wc_we(policy.cast_compute(site["w"]), dtype=dt)
        return conv3x3_wp_raw(xp, wc, we, bias=site["b"].repeat(2),
                              bias_relu=True)

    x1_wp = cbr_wp(hp, fp["inc"]["conv2"])
    hp2 = _pool_wp_val(x1_wp)                        # packed -> stacked

    # mid-network: identical to unet_infer_stacked from down1 onward
    hh = I._cbr_stacked(hp2, fp["down1"]["conv1"], policy)
    c1 = hh.shape[-1] // 2
    xb = torch.cat([hh[..., :c1], hh[..., c1:]], dim=0)
    y = I._mid(fp, xb, policy)
    y2s = torch.cat([y[:bsz], y[bsz:]], dim=-1)

    up = fp["up4"]["up"]
    u_wp = convT_wp(y2s, up["w"], up["b"], policy=policy)
    pc = fp["up4"]["conv"]
    wc1 = policy.cast_compute(pc["conv1"]["w"])
    wca, wea = make_wc_we(wc1[:, :, :64], dtype=dt)
    wcb, web = make_wc_we(wc1[:, :, 64:], dtype=dt)
    ya = conv3x3_wp2_raw(x1_wp, u_wp, wca, wea, wcb, web,
                         bias=pc["conv1"]["b"].repeat(2), bias_relu=True)
    y1_wp = cbr_wp(ya, pc["conv2"])
    return x1_wp, y1_wp


def wp_supported(x_shape, base: int) -> bool:
    """The wp path covers the production geometry: base-64 weight-shared
    nets with H a multiple of 8 and W a multiple of 4, W >= 8. Everything
    else takes the stacked path."""
    h, w = x_shape[1], x_shape[2]
    return base == 64 and h % 8 == 0 and w % 4 == 0 and w >= 8
