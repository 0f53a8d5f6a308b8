"""Width-pair-packed serving path (``onet_tpu/models/wp.py``, serving subset).

The 512^2-scale levels of the BN-folded U-Net run on the hand-written
pair-packed conv kernels (ops/conv_wp.py):

  inc.conv1 + bias + relu   cuDNN, channel-stacked  [B, H, W, 128]
  pack_wp                   one relayout            [2B, H, W/2, 128]
  inc.conv2 + bias + relu   KERNEL conv3x3_wp_raw   stays packed
  _pool_wp_val              packed -> channel-stacked [B, H/2, W/2, 128]
  down1 .. up3              the stacked path of models/infer.py
  up4.up (convT)            f32-accumulated matmul, EMITS packed
  up4.conv1 + bias + relu   KERNEL conv3x3_wp2_raw (skip, up), no concat
  up4.conv2 + bias + relu   KERNEL conv3x3_wp_raw
  head_wp                   packed reductions -> [B, H, W, 2]
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import infer as I
from onet_tpu_torch.ops.conv_wp import (
    conv3x3_wp_raw, conv3x3_wp2_raw, make_wc_we, pack_wp)


def _pool_wp_val(x):
    """2x2 max pool on packed [2B, H, Wp, 128], emitting the
    channel-stacked [B, H/2, Wp, 128] tensor the mid-network takes."""
    b = x.shape[0] // 2
    m1 = torch.maximum(x[..., :64], x[..., 64:])     # over column parity
    m2 = torch.maximum(m1[:, ::2], m1[:, 1::2])      # over row pairs
    return torch.cat([m2[:b], m2[b:]], dim=-1)


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
