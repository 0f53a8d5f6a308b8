"""Functional layers for the U-Net, forward subset (``onet_tpu/models/layers.py``).

Tensors are NHWC at every function boundary, as in the JAX package. A
contiguous NHWC tensor permuted to NCHW is exactly PyTorch's
``channels_last`` layout, so the cuDNN calls below take and return
channels-last tensors without a copy. Weights keep the JAX HWIO layout and
are permuted to PyTorch's at the call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from onet_tpu_torch.core.policy import Policy, DEFAULT

BN_EPS = 1e-5


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
