"""Native-layout 3x3 convolution with the fused BatchNorm-stats epilogue
(``onet_tpu/ops/pallas_conv_bd.py``).

The channel-stacked layout carries both weight-shared branches as one
[N, H, W, 128] tensor (lanes = (branch, channel)); with the block-diagonal
weight of ``models/layers.py::bd2`` a dense 128->128 conv computes both
branches, and per-lane sums over a sample's pixels are the per-branch
BatchNorm statistics, taken from the f32 accumulator so no pass re-reads y.

``conv3x3_bd_raw`` and ``conv3x3_bd2in_raw`` keep the JAX functions'
contract: x and w are cast to bf16 whatever their dtype, the products
accumulate in f32, y is stored in ``out_dtype`` (default x's), and with
``stats=True`` also (s1, s2), each [N, 128] f32. The weight is any dense
[3, 3, 128, 128] HWIO kernel. The JAX functions' ``rblk`` (the TPU row
block) and ``interpret`` (Pallas interpret mode) are TPU knobs and are left
out. On a CPU tensor the wrappers run the plain PyTorch version below (the
same bf16-rounded operands, nine f32 tap products); on a CUDA tensor they
launch the hand-written kernel of ``csrc/conv_bd.cu`` (which replaces
``_bd_fwd_kernel`` and ``_bd_fwd2_kernel``, ``pallas_conv_bd.py:96,119``)
or raise. Each wrapper counts its kernel launches in ``.launches``.

``conv_stats_library`` is the counterpart of ``xla_conv_stats``: one cuDNN
convolution (``F.conv2d``) and a separate f32 stats pass over its stored
output. It is the yardstick the probe and the tests compare against; no
path of the port calls it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from onet_tpu_torch.ops import _build

L = 128                 # lanes of the stacked layout
TH, TW = 8, 32          # the kernel's output tile (rows, pixels)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc_plain(x, w):
    """f32 accumulator of one SAME conv: the nine tap products of the
    bf16-rounded operands (exact in f32), summed tap by tap."""
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(torch.bfloat16).float()
    acc = None
    for di in range(3):
        for dj in range(3):
            t = xp[:, di:di + h, dj:dj + wd] @ wf[di, dj]
            acc = t if acc is None else acc + t
    return acc


def _finish_plain(acc, stats, out_dtype):
    y = acc.to(out_dtype)
    if stats:
        return y, acc.sum(dim=(1, 2)), acc.square().sum(dim=(1, 2))
    return y


def conv3x3_bd_plain(x, w, *, stats=False, out_dtype=None):
    """Plain PyTorch version of ``conv3x3_bd_raw``."""
    return _finish_plain(_acc_plain(x, w), stats, out_dtype or x.dtype)


def conv3x3_bd2in_plain(xa, xb, wa, wb, *, stats=False, out_dtype=None):
    """Plain PyTorch version of ``conv3x3_bd2in_raw``."""
    acc = _acc_plain(xa, wa) + _acc_plain(xb, wb)
    return _finish_plain(acc, stats, out_dtype or xa.dtype)


def conv_stats_library(x, w):
    """cuDNN's conv on the bf16 operands, then the per-lane stats of its
    stored output in f32 (the ``xla_conv_stats`` formulation). Returns
    (y [N, H, W, 128] bf16, s1, s2 [N, Cout] f32)."""
    xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = w.to(torch.bfloat16).permute(3, 2, 0, 1)
    y = F.conv2d(xb, wb, padding=1).permute(0, 2, 3, 1)
    yf = y.float()
    return y, yf.sum(dim=(1, 2)), yf.square().sum(dim=(1, 2))


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on the card
# ---------------------------------------------------------------------------

def _check(xs, ws):
    x0 = xs[0]
    if x0.ndim != 4 or x0.shape[-1] != L:
        raise ValueError(f"expected a stacked [N, H, W, {L}] input, got "
                         f"{tuple(x0.shape)}")
    for x in xs[1:]:
        if x.shape != x0.shape or x.device != x0.device:
            raise ValueError(f"inputs differ: {tuple(x.shape)} {x.device} vs "
                             f"{tuple(x0.shape)} {x0.device}")
    for w in ws:
        if tuple(w.shape) != (3, 3, L, L) or w.device != x0.device:
            raise ValueError(f"expected a [3, 3, {L}, {L}] weight on "
                             f"{x0.device}, got {tuple(w.shape)} on "
                             f"{w.device}")


def _launch(xs, ws, stats, out_dtype):
    """Run csrc/conv_bd.cu on CUDA tensors; returns y [N, H, W, 128], and
    with ``stats`` also (s1, s2) [N, 128] f32."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_bd kernel stores bf16 or f32, not {out_dtype}")
    xs = [x.to(torch.bfloat16).contiguous() for x in xs]
    ws = [w.to(torch.bfloat16).contiguous() for w in ws]
    x0 = xs[0]
    dev = x0.device
    n, h, wd, _ = x0.shape
    y = torch.empty((n, h, wd, L), dtype=out_dtype, device=dev)
    for t in (*xs, *ws, y):
        if t.data_ptr() % 16:
            raise ValueError("conv_bd kernel needs 16-byte aligned tensors")
    if stats:
        tiles = n * -(-h // TH) * -(-wd // TW)
        part = torch.empty((tiles, 2 * L), dtype=torch.float32, device=dev)
        s1 = torch.empty((n, L), dtype=torch.float32, device=dev)
        s2 = torch.empty((n, L), dtype=torch.float32, device=dev)
        ptrs = (part.data_ptr(), s1.data_ptr(), s2.data_ptr())
    else:
        ptrs = (0, 0, 0)
    fn = _build.load("conv_bd").onet_conv3x3_bd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x1 = xs[1] if len(xs) > 1 else x0
    w1 = ws[1] if len(ws) > 1 else ws[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x0.data_ptr(), x1.data_ptr(), ws[0].data_ptr(),
                 w1.data_ptr(), y.data_ptr(), *ptrs, n, h, wd, len(xs),
                 int(out_dtype == torch.bfloat16), int(bool(stats)), stream)
    if err:
        raise RuntimeError(f"conv_bd kernel launch failed: CUDA error {err}")
    return (y, s1, s2) if stats else y


def conv3x3_bd_raw(x, w, *, stats: bool = False, out_dtype=None):
    """SAME 3x3 conv at the stacked layout, optional stats epilogue.

    x: [N, H, W, 128]; w: [3, 3, 128, 128] dense HWIO; both cast to bf16.
    Returns y [N, H, W, 128] (out_dtype, default x.dtype); with
    ``stats=True`` also (s1, s2), each [N, 128] f32: per-sample per-lane
    sum and sum of squares of the f32 accumulator before the cast."""
    _check([x], [w])
    out_dtype = out_dtype or x.dtype
    if _build.on_cpu(x, "conv_bd"):
        return conv3x3_bd_plain(x, w, stats=stats, out_dtype=out_dtype)
    out = _launch([x], [w], stats, out_dtype)
    conv3x3_bd_raw.launches += 1
    return out


def conv3x3_bd2in_raw(xa, xb, wa, wb, *, stats: bool = False,
                      out_dtype=None):
    """Two-input form y = conv(xa, wa) + conv(xb, wb): the decoder's
    concat(skip, up) conv without the 256-lane concat. Same contract as
    conv3x3_bd_raw."""
    _check([xa, xb], [wa, wb])
    out_dtype = out_dtype or xa.dtype
    if _build.on_cpu(xa, "conv_bd"):
        return conv3x3_bd2in_plain(xa, xb, wa, wb, stats=stats,
                                   out_dtype=out_dtype)
    out = _launch([xa, xb], [wa, wb], stats, out_dtype)
    conv3x3_bd2in_raw.launches += 1
    return out


conv3x3_bd_raw.launches = 0
conv3x3_bd2in_raw.launches = 0
