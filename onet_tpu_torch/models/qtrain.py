"""Opt-in reduced-precision (int8) training arithmetic
(``onet_tpu/models/qtrain.py``).

``make_qtrain_ops(level)`` returns an ops namespace (the injection point
of ``models/unet.py``) whose 3x3 convs run:

  level "fwd":    int8 forward (dynamic per-tensor activation scale,
                  per-output-channel weight scales) on the hand-written
                  kernel (``ops/conv_i8.py``), bf16 backward from the
                  int8-dequantized residuals (straight-through) on cuDNN;
  level "fwd+dx": additionally the input-gradient conv in int8 (dynamic
                  signed quantization of the incoming cotangent, with the
                  weights' per-channel scales folded in) on the same
                  kernel; the weight gradient stays bf16 always.

BatchNorm, pooling, the transposed convs, the head and the loss stay in
the exact path. ``onet_forward`` takes the stacked graph with these ops,
never the pair-packed one.

Accuracy contract, as the JAX package's: opt-in, gated on mask agreement
of the trained model against an exactly trained one from the same
init and data (``tests/test_torch_qtrain.py``).

Under a mesh the activation scales are global, as in the JAX package,
whose jitted step takes ``_quant_act``'s max over the whole sharded batch:
the max runs through a MAX all-reduce over the axes the step shards, the
BatchNorm axes that ``train/steps.py::make_loss_and_grads`` sets
(``models/layers.py::bn_axis``: ``data``, and ``space`` / ``spacew`` on
the halo step). The forward reads them when it runs and keeps them for
the backward's dy scale.

Scales divide by tensors, never by a Python scalar (PyTorch's CUDA
kernels multiply by a scalar divisor's reciprocal). The first conv's
input needs no gradient, so its dx conv is not run (the JAX package's is
computed and dropped by XLA).
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.ops.conv_i8 import QMAX, conv3x3_i8
from onet_tpu_torch.ops.math import div
from onet_tpu_torch.parallel.collectives import all_reduce_


def _quant_act(x, axis=None):
    """Dynamic per-tensor symmetric int8: returns (codes, scale), the
    scale a 0-d f32 tensor. ``axis``: the mesh axis the tensor is sharded
    over; its max is taken over the whole of it."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    if axis is not None:
        amax = all_reduce_(amax.contiguous(), axis, op=dist.ReduceOp.MAX,
                           name="quant_max")
    s = torch.clamp_min(div(amax, QMAX), 1e-12)
    q = torch.clamp(torch.round(xf / s), -QMAX, QMAX)
    return q.to(torch.int8), s


def _quant_w_oc(w):
    """Per-output-channel symmetric int8 weights: (codes, scale[co])."""
    wf = w.float()
    sw = torch.clamp_min(div(torch.amax(torch.abs(wf), dim=(0, 1, 2)), QMAX),
                         1e-12)
    wq = torch.clamp(torch.round(wf / sw), -QMAX, QMAX)
    return wq.to(torch.int8), sw


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class _ConvQ(torch.autograd.Function):
    """3x3 SAME conv with int8 forward arithmetic (the JAX package's
    ``conv3x3_q`` custom_vjp). Forward: x per tensor and w per output
    channel to int8, the int8 kernel, y = acc * (sx * sw) in f32, cast to
    the compute dtype. Backward (straight-through): dx and dw are the
    cotangents of the bf16 conv over exactly the values the forward
    multiplied (xdeq, wdeq); dx optionally from the int8 kernel on the
    flip-transposed codes and dy * sw requantized per tensor; dw in f32
    (from bf16, as JAX's bf16 cotangent)."""

    @staticmethod
    def forward(ctx, x, w, compute_dtype, dx_int8):
        axis = L.current_bn_axis()
        xq, sx = _quant_act(x, axis)
        wq, sw = _quant_w_oc(w)
        y = conv3x3_i8(xq, wq, sx * sw)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.compute_dtype, ctx.dx_int8 = compute_dtype, dx_int8
        ctx.axis = axis
        return y.to(compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        xq, sx, wq, sw = ctx.saved_tensors
        dyf = dy.to(torch.bfloat16)
        xdeq = (xq.float() * sx).to(torch.bfloat16)
        wdeq = (wq.float() * sw).to(torch.bfloat16)
        w_oihw = wdeq.permute(3, 2, 0, 1)
        dy_nchw = _nchw(dyf)
        dw = torch.nn.grad.conv2d_weight(_nchw(xdeq), w_oihw.shape, dy_nchw,
                                         padding=1)
        dw = dw.permute(2, 3, 1, 0).float()
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.dx_int8:
                # dx = corr(dy * sw per channel, wq flip-transposed): the
                # weight codes' per-output-channel scale folded into dy,
                # then one int8 conv
                wtq = wq.flip(0, 1).permute(0, 1, 3, 2)
                dyq2, sdy2 = _quant_act(dyf.float() * sw, ctx.axis)
                dx = conv3x3_i8(dyq2, wtq, sdy2.expand(wq.shape[2])
                                .contiguous())
            else:
                dx = torch.nn.grad.conv2d_input(
                    _nchw(xdeq).shape, w_oihw, dy_nchw, padding=1)
                dx = dx.permute(0, 2, 3, 1)
            dx = dx.to(ctx.compute_dtype)
        return dx, dw, None, None


def conv3x3_q(x, w, compute_dtype, dx_int8):
    """3x3 SAME conv with int8 forward arithmetic; see ``_ConvQ``."""
    return _ConvQ.apply(x, w, compute_dtype, dx_int8)


def make_qtrain_ops(*, level: str = "fwd") -> types.SimpleNamespace:
    """Ops namespace for models/unet.py with int8 conv arithmetic.

    level: "fwd" (int8 forward only) or "fwd+dx" (also int8
    input-gradient). Pool / BN / convT stay on the exact default ops.
    """
    assert level in ("fwd", "fwd+dx"), level
    dx_int8 = level == "fwd+dx"

    def conv3x3(x, w, *, policy: Policy = DEFAULT):
        return conv3x3_q(policy.cast_compute(x), w, policy.compute_dtype,
                         dx_int8)

    return types.SimpleNamespace(
        conv3x3=conv3x3,
        batch_norm=L.batch_norm,
        max_pool=L.max_pool_2x2,
        conv_transpose=L.conv_transpose_2x2,
    )
