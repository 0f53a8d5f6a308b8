"""Functional layers for the U-Net (``onet_tpu/models/layers.py``).

Tensors are NHWC at every function boundary, as in the JAX package. A
contiguous NHWC tensor permuted to NCHW is exactly PyTorch's
``channels_last`` layout, so the cuDNN calls below take and return
channels-last tensors without a copy. Weights keep the JAX HWIO layout and
are permuted to PyTorch's at the call.

Training-mode BatchNorm keeps the JAX package's branch-grouped statistics
(block, interleaved and channel-stacked layouts), its arithmetic (biased
variance as E[x^2] - mean^2 in f32) and its hand-written backward
(``torch.autograd.Function`` for each ``jax.custom_vjp``); the running
statistics replay the reference's sequential EMA in branch order, outside
the graph. Pool and transposed conv differentiate through PyTorch's own
backward: ``max_pool2d`` routes a window's gradient to its first maximum in
scan order, the first-match rule of the JAX package's select_and_scatter.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from onet_tpu_torch.core.policy import Policy, DEFAULT

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# initializers (CPU generator, so a seed gives the same weights on any device)
# ---------------------------------------------------------------------------

def kaiming_normal_conv(gen: torch.Generator, kh, kw, cin, cout,
                        dtype=torch.float32):
    """Kaiming normal, fan_in, relu gain: std = sqrt(2 / (cin*kh*kw))."""
    std = math.sqrt(2.0 / (cin * kh * kw))
    return std * torch.randn((kh, kw, cin, cout), generator=gen, dtype=dtype)


def torch_default_convT(gen: torch.Generator, kh, kw, cin, cout,
                        dtype=torch.float32):
    """PyTorch's default ConvTranspose2d init (kaiming_uniform(a=sqrt(5)),
    fan_in = cout*kh*kw), stored HWIO; bias ~ U(+-1/sqrt(fan_in))."""
    fan_in = cout * kh * kw
    bound = math.sqrt(3.0) * math.sqrt(2.0 / 6.0) / math.sqrt(fan_in)
    w = (torch.rand((kh, kw, cin, cout), generator=gen, dtype=dtype)
         * 2 - 1) * bound
    b_bound = 1.0 / math.sqrt(fan_in)
    b = (torch.rand((cout,), generator=gen, dtype=dtype) * 2 - 1) * b_bound
    return w, b


def bn_init(c, dtype=torch.float32):
    params = {"scale": torch.ones(c, dtype=dtype),
              "bias": torch.zeros(c, dtype=dtype)}
    state = {"mean": torch.zeros(c, dtype=torch.float32),
             "var": torch.ones(c, dtype=torch.float32)}
    return params, state


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv3x3(x, w, *, policy: Policy = DEFAULT):
    """3x3 stride-1 SAME conv, no bias; output in the compute dtype."""
    y = F.conv2d(_nchw(policy.cast_compute(x)),
                 policy.cast_compute(w).permute(3, 2, 0, 1), padding=1)
    return _nhwc(y)


def max_pool_2x2(x):
    """2x2 stride-2 max pool with PyTorch's floor semantics: an odd
    trailing row or column is dropped."""
    return _nhwc(F.max_pool2d(_nchw(x), 2))


def conv_transpose_2x2(x, w, b, *, policy: Policy = DEFAULT):
    """Kernel-2 stride-2 transposed conv + bias (ConvTranspose2d):
    y[n, 2i+di, 2j+dj, o] = sum_c x[n,i,j,c] w[di,dj,c,o], no flip.
    The bias is added in the compute dtype, as the JAX package does."""
    y = F.conv_transpose2d(_nchw(policy.cast_compute(x)),
                           policy.cast_compute(w).permute(2, 3, 0, 1),
                           stride=2)
    y = _nhwc(y)
    return y + b.to(y.dtype)


def bd2(w):
    """Block-diagonal duplication of a shared conv weight:
    [kh, kw, ci, co] -> [kh, kw, 2ci, 2co], w on both diagonal blocks."""
    z = torch.zeros_like(w)
    top = torch.cat([w, z], dim=3)
    bot = torch.cat([z, w], dim=3)
    return torch.cat([top, bot], dim=2)


def interleave_branches(h):
    """Channel-stacked [N, H, W, 2C] -> batch-interleaved [2N, H, W, C]
    (out[2i + b] = branch b of sample i)."""
    n, hh, ww, c2 = h.shape
    c = c2 // 2
    return (h.reshape(n, hh, ww, 2, c).permute(0, 3, 1, 2, 4)
            .reshape(2 * n, hh, ww, c))


def restack_branches(y):
    """Batch-interleaved [2N, H, W, C] -> channel-stacked [N, H, W, 2C];
    inverse of interleave_branches."""
    n2, hh, ww, c = y.shape
    n = n2 // 2
    return (y.reshape(n, 2, hh, ww, c).permute(0, 2, 3, 1, 4)
            .reshape(n, hh, ww, 2 * c))


def bd2_skip_up(w, c_skip: int):
    """bd2 for the decoder conv whose stacked input is laid out
    [s1|s2|u1|u2]; per-branch w is [kh, kw, c_skip + c_up, co]."""
    ws, wu = w[:, :, :c_skip, :], w[:, :, c_skip:, :]
    zs, zu = torch.zeros_like(ws), torch.zeros_like(wu)
    rows = [
        torch.cat([ws, zs], dim=3),   # s1 -> branch-0 outputs
        torch.cat([zs, ws], dim=3),   # s2 -> branch-1 outputs
        torch.cat([wu, zu], dim=3),   # u1 -> branch-0
        torch.cat([zu, wu], dim=3),   # u2 -> branch-1
    ]
    return torch.cat(rows, dim=2)


def relu(x):
    return torch.clamp_min(x, 0)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def _group_view(groups, interleaved):
    """(reshape, reduce dims, [G, C] broadcaster) of a branch-grouped batch.
    Block layout: [N, ...] -> [G, N/G, ...] (branch b = slab b);
    interleaved (what interleave_branches emits): [N/G, G, ...] (branch b =
    every G-th sample from b). Group index b is branch b either way."""
    if interleaved:
        return (lambda t, n, h, w, c, g: t.reshape(n // g, g, h, w, c),
                (0, 2, 3),
                lambda t: t[None, :, None, None, :])
    return (lambda t, n, h, w, c, g: t.reshape(g, n // g, h, w, c),
            (1, 2, 3),
            lambda t: t[:, None, None, None, :])


class _BnTrain(torch.autograd.Function):
    """Train-mode BN core with per-branch-group statistics and a shared
    affine: (x, scale, bias) -> (y, mean, var), mean/var [G, C] f32 (biased
    variance; no gradient, they feed the EMA only). The backward saves the
    compute-dtype x and the [G, C] statistics and recomputes x_hat."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, interleaved):
        n, h, w, c = x.shape
        view, red, bcast = _group_view(groups, interleaved)
        xf = view(x, n, h, w, c, groups).float()
        mean = xf.mean(dim=red)
        var = xf.square().mean(dim=red) - mean.square()
        inv = torch.rsqrt(var + eps)
        y = (xf - bcast(mean)) * bcast(inv * scale.float())
        y = (y + bias.float()).reshape(n, h, w, c).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.groups, ctx.interleaved = groups, interleaved
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        n, h, w, c = x.shape
        g = ctx.groups
        cnt = (n // g) * h * w
        view, red, bcast = _group_view(g, ctx.interleaved)
        xg = view(x, n, h, w, c, g).float()
        dyg = view(dy, n, h, w, c, g).float()
        xhat = (xg - bcast(mean)) * bcast(inv)
        sum_dy = dyg.sum(dim=red)                                  # [G, C]
        sum_dy_xhat = (dyg * xhat).sum(dim=red)
        dx = (bcast(inv * scale.float())
              * (dyg - bcast(sum_dy / cnt) - xhat * bcast(sum_dy_xhat / cnt)))
        dx = dx.reshape(n, h, w, c).to(x.dtype)
        return (dx, sum_dy_xhat.sum(0).to(scale.dtype),
                sum_dy.sum(0).to(scale.dtype), None, None, None)


class _BnTrainCh(torch.autograd.Function):
    """Train-mode BN for channel-stacked branches: x [N, H, W, G*C], branch
    b in channel block b; plain per-channel batch statistics, the affine
    tiled. Returns (y, mean, var) with mean/var [G, C] like _BnTrain."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        c = x.shape[-1] // groups
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))                              # [G*C]
        var = xf.square().mean(dim=(0, 1, 2)) - mean.square()
        inv = torch.rsqrt(var + eps)
        scale2 = scale.float().repeat(groups)
        bias2 = bias.float().repeat(groups)
        y = ((xf - mean) * (inv * scale2) + bias2).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.groups = groups
        mean_g, var_g = mean.reshape(groups, c), var.reshape(groups, c)
        ctx.mark_non_differentiable(mean_g, var_g)
        return y, mean_g, var_g

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        n, h, w, c2 = x.shape
        g = ctx.groups
        cnt = n * h * w
        xf, dyf = x.float(), dy.float()
        xhat = (xf - mean) * inv
        sum_dy = dyf.sum(dim=(0, 1, 2))                            # [G*C]
        sum_dy_xhat = (dyf * xhat).sum(dim=(0, 1, 2))
        scale2 = scale.float().repeat(g)
        dx = ((inv * scale2)
              * (dyf - sum_dy / cnt - xhat * (sum_dy_xhat / cnt))).to(x.dtype)
        dscale = sum_dy_xhat.reshape(g, c2 // g).sum(0).to(scale.dtype)
        dbias = sum_dy.reshape(g, c2 // g).sum(0).to(scale.dtype)
        return dx, dscale, dbias, None, None


def ema_update(state, mean, var, cnt: int, momentum: float = BN_MOMENTUM):
    """The reference's per-call running-stats EMA replayed in branch order
    over the [G, C] batch statistics: r <- (1-m) r + m s_b for b = 0, 1, ...
    with the unbiased variance. Outside the graph."""
    with torch.no_grad():
        unbiased = var * (cnt / max(cnt - 1, 1))
        r_mean, r_var = state["mean"], state["var"]
        for i in range(mean.shape[0]):
            r_mean = (1 - momentum) * r_mean + momentum * mean[i]
            r_var = (1 - momentum) * r_var + momentum * unbiased[i]
    return {"mean": r_mean, "var": r_var}


def batch_norm(x, params, state, *, train: bool, groups: int = 1,
               momentum: float = BN_MOMENTUM, eps: float = BN_EPS,
               stacked: bool = False, interleaved: bool = False):
    """BatchNorm2d with branch-group statistics; returns (y, new_state).

    ``groups=G`` treats the batch as G branches of N/G frames (block slabs,
    or sample-major with ``interleaved``) and normalizes each with its own
    statistics, as if the branches ran through the layer one after the
    other. ``stacked=True`` treats the channel axis as G branch blocks
    instead (params/state stay [C]). Normalization uses the biased
    variance, the EMA the unbiased one (torch semantics)."""
    if train:
        n, h, w, _ = x.shape
        cnt = (n // (1 if stacked else groups)) * h * w
        if stacked:
            y, mean, var = _BnTrainCh.apply(x, params["scale"],
                                            params["bias"], groups, eps)
        else:
            y, mean, var = _BnTrain.apply(x, params["scale"], params["bias"],
                                          groups, eps, interleaved)
        return y, ema_update(state, mean, var, cnt, momentum)
    sf, bf = params["scale"].float(), params["bias"].float()
    if stacked:
        mean = state["mean"].repeat(groups)
        inv = torch.rsqrt(state["var"].repeat(groups) + eps)
        y = (x.float() - mean) * inv * sf.repeat(groups) + bf.repeat(groups)
        return y.to(x.dtype), state
    inv = torch.rsqrt(state["var"] + eps)
    y = (x.float() - state["mean"]) * inv
    return (y * sf + bf).to(x.dtype), state
