"""The fused JSD head loss and the fused min-max/complement input pass
(``onet_tpu/ops/pallas_head.py``).

``fused_jsd_loss(lt, ht, ld, hd)`` is the symmetric JSD loss of the Onet
from the four [B, H, W, C] feature maps in one pass; ``minmax_complement``
and ``paired_input`` build the normalized frame and its complement in one
pass. Per pixel (c indexes channels):

    ct = sum_c Lt, vt = sum_c Lt*Ht   (and likewise cd, vd)
    st = sigmoid(vt - vd), sd = 1 - st
    loss = sum over pixels of
        (l1p(-ct*st) + l1p(ct*sd) + l1p(-cd*sd) + l1p(cd*st)) / (2N)

which equals ``models/onet.py::compute_loss`` of the same features. The
backward recomputes the pixel's sums from the inputs (no residuals), with
g1 = -s(-ct*st), g2 = s(ct*sd), g3 = -s(-cd*sd), g4 = s(cd*st):

    dct = (g1*st + g2*sd)*k, dcd = (g3*sd + g4*st)*k, k = dloss/(2N)
    dst = (g1*ct + g4*cd)*k, dsd = (g2*ct + g3*cd)*k
    dvt = (dst - dsd)*st*sd, dvd = -dvt
    dLt = dct + dvt*Ht, dHt = dvt*Lt, dLd = dcd + dvd*Hd, dHd = dvd*Ld

On a CPU tensor every wrapper runs its plain PyTorch version below, which
repeats the kernel's arithmetic in f32; on a CUDA tensor it launches the
hand-written kernel of ``csrc/head.cu`` or raises. Each wrapper counts its
kernel launches in ``.launches``: ``jsd_loss_fwd`` (replaces
``_head_fwd_kernel``, ``pallas_head.py:67``), ``jsd_loss_bwd``
(``_head_bwd_kernel``, ``:89``) and ``minmax_complement``
(``_minmax_comp_kernel``, ``:220``; ``paired_input`` launches the same
kernel and counts there). The C functions' signatures are set once
(``_lib``); the forward grid and the min-max chunk count are computed once
per size.

Contract difference: the JAX forward falls back to XLA, and its backward
raises, when no multiple-of-8 row block divides the pixel count. Here both
directions take any pixel count and any C.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from onet_tpu_torch.ops import _build
from onet_tpu_torch.ops.math import log1pexp

MINMAX_EPS = 1.1920929e-07   # the TPU kernel's epsilon, not ops.normalize.EPS
_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in f32
# ---------------------------------------------------------------------------

def _pixel_sums(lt, ht, ld, hd):
    ltf, htf, ldf, hdf = (a.float() for a in (lt, ht, ld, hd))
    ct, cd = ltf.sum(-1), ldf.sum(-1)
    vt, vd = (ltf * htf).sum(-1), (ldf * hdf).sum(-1)
    st = torch.sigmoid(vt - vd)
    return (ltf, htf, ldf, hdf), ct, cd, st, 1.0 - st


def jsd_loss_fwd_plain(lt, ht, ld, hd):
    """Plain version of the forward kernel: the f32 scalar loss."""
    _, ct, cd, st, sd = _pixel_sums(lt, ht, ld, hd)
    terms = (log1pexp(-ct * st) + log1pexp(ct * sd)
             + log1pexp(-cd * sd) + log1pexp(cd * st))
    return terms.sum() / (2.0 * ct.numel())


def jsd_loss_bwd_plain(lt, ht, ld, hd, scale):
    """Plain version of the backward kernel; ``scale`` = dloss / (2N), a
    tensor. Returns (dLt, dHt, dLd, dHd), each in its input's dtype."""
    (ltf, htf, ldf, hdf), ct, cd, st, sd = _pixel_sums(lt, ht, ld, hd)
    k = scale.float().reshape(())
    g1 = -torch.sigmoid(-ct * st)
    g2 = torch.sigmoid(ct * sd)
    g3 = -torch.sigmoid(-cd * sd)
    g4 = torch.sigmoid(cd * st)
    dct = ((g1 * st + g2 * sd) * k)[..., None]
    dcd = ((g3 * sd + g4 * st) * k)[..., None]
    dst = (g1 * ct + g4 * cd) * k
    dsd = (g2 * ct + g3 * cd) * k
    dvt = ((dst - dsd) * st * sd)[..., None]
    dvd = -dvt
    return ((dct + dvt * htf).to(lt.dtype), (dvt * ltf).to(ht.dtype),
            (dcd + dvd * hdf).to(ld.dtype), (dvd * ldf).to(hd.dtype))


def minmax_complement_plain(x):
    """Plain version of the min-max kernel: per-frame min/max over
    (H, W, C), f32 arithmetic, outputs in x's dtype."""
    xf = x.float()
    lo = xf.amin(dim=(1, 2, 3), keepdim=True)
    hi = xf.amax(dim=(1, 2, 3), keepdim=True)
    xn = (xf - lo) / (hi - lo + MINMAX_EPS)
    xc = torch.clamp(1.0 - xn, 0.0, 1.0)
    return xn.to(x.dtype), xc.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels of csrc/head.cu
# ---------------------------------------------------------------------------

def _check_feats(ts):
    t0 = ts[0]
    if t0.ndim != 4:
        raise ValueError(f"expected [B, H, W, C] features, got "
                         f"{tuple(t0.shape)}")
    for t in ts[1:]:
        if t.shape != t0.shape or t.device != t0.device:
            raise ValueError(f"features differ: {tuple(t.shape)} {t.device} "
                             f"vs {tuple(t0.shape)} {t0.device}")


def _kernel_inputs(ts):
    """Contiguous CUDA inputs of one supported dtype, and whether the
    kernel may use 16-byte vector loads (rows of 16-byte multiples, every
    pointer aligned)."""
    dtype = ts[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in ts):
        raise TypeError("head kernels take four bf16 or four f32 tensors, "
                        f"got {[t.dtype for t in ts]}")
    ts = [t.contiguous() for t in ts]
    c = ts[0].shape[-1]
    vec = (c * ts[0].element_size()) % 16 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in ts)
    return ts, vec


@functools.cache
def _lib():
    """csrc/head.cu's C functions, their signatures set once."""
    lib = _build.load("head")
    sig = {"onet_head_fwd_blocks": ([ctypes.c_longlong], ctypes.c_int),
           "onet_minmax_chunks": ([ctypes.c_longlong], ctypes.c_int),
           "onet_head_fwd": ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                             ctypes.c_int),
           "onet_head_bwd": ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                             ctypes.c_int),
           "onet_minmax_complement": (
               [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_void_p],
               ctypes.c_int)}
    fns = {}
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
        fns[name] = fn
    return fns


@functools.cache
def _fwd_blocks(npix: int) -> int:
    """The forward kernel's fixed grid, once per pixel count (all it
    depends on)."""
    return _lib()["onet_head_fwd_blocks"](npix)


@functools.cache
def _minmax_chunks(m: int) -> int:
    """The min-max kernel's chunks per frame, once per frame size (all it
    depends on)."""
    return _lib()["onet_minmax_chunks"](m)


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def jsd_loss_fwd(lt, ht, ld, hd):
    """The JSD loss (f32 scalar tensor) of the four [B, H, W, C] maps."""
    _check_feats([lt, ht, ld, hd])
    if _build.on_cpu(lt, "head ops"):
        return jsd_loss_fwd_plain(lt, ht, ld, hd)
    ts, vec = _kernel_inputs([lt, ht, ld, hd])
    b, h, w, c = lt.shape
    npix = b * h * w
    dev = lt.device
    nblk = _fwd_blocks(npix)
    part = torch.empty(nblk, dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    fn = _lib()["onet_head_fwd"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in ts), part.data_ptr(),
                 loss.data_ptr(), npix, c, int(lt.dtype == torch.bfloat16),
                 int(vec), nblk, stream)
    _raise_on(err, "head forward")
    jsd_loss_fwd.launches += 1
    return loss


def jsd_loss_bwd(lt, ht, ld, hd, scale):
    """The four input gradients of the JSD loss for the cotangent scale
    ``scale`` = dloss / (2N), a one-element f32 tensor on the inputs'
    device (no host sync), each gradient in its input's dtype."""
    _check_feats([lt, ht, ld, hd])
    if _build.on_cpu(lt, "head ops"):
        return jsd_loss_bwd_plain(lt, ht, ld, hd, scale)
    ts, vec = _kernel_inputs([lt, ht, ld, hd])
    scale = scale.reshape(1).to(lt.device, torch.float32).contiguous()
    b, h, w, c = lt.shape
    outs = [torch.empty_like(t) for t in ts]
    vec = vec and all(o.data_ptr() % 16 == 0 for o in outs)
    fn = _lib()["onet_head_bwd"]
    with torch.cuda.device(lt.device):
        stream = torch.cuda.current_stream(lt.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ts), scale.data_ptr(),
                 *(o.data_ptr() for o in outs), b * h * w, c,
                 int(lt.dtype == torch.bfloat16), int(vec), stream)
    _raise_on(err, "head backward")
    jsd_loss_bwd.launches += 1
    return tuple(outs)


class _FusedJsd(torch.autograd.Function):
    """The JAX ``custom_vjp``: forward kernel, recompute backward kernel."""

    @staticmethod
    def forward(ctx, lt, ht, ld, hd):
        ctx.save_for_backward(lt, ht, ld, hd)
        return jsd_loss_fwd(lt, ht, ld, hd)

    @staticmethod
    def backward(ctx, dloss):
        lt, ht, ld, hd = ctx.saved_tensors
        npix = lt.numel() // lt.shape[-1]
        scale = dloss.float() / (2.0 * npix)    # stays on the device
        return jsd_loss_bwd(lt, ht, ld, hd, scale)


def fused_jsd_loss(lt, ht, ld, hd):
    """The symmetric JSD loss from the four feature maps [B, H, W, C], one
    fused pass each way (differentiable in all four)."""
    return _FusedJsd.apply(lt, ht, ld, hd)


def _minmax_launch(x, xn, xc):
    """Run the two-pass min-max kernel on CUDA x [B, H, W, C], writing the
    normalized frames to xn and the complements to xc (contiguous views of
    x's shape and dtype)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"min-max kernel takes bf16 or f32, got {x.dtype}")
    b = x.shape[0]
    m = x.numel() // b if b else 0
    nchunk = _minmax_chunks(m)
    part = torch.empty((2, b, max(nchunk, 1)), dtype=torch.float32,
                       device=x.device)
    fn = _lib()["onet_minmax_complement"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), part.data_ptr(), xn.data_ptr(), xc.data_ptr(),
                 b, m, int(x.dtype == torch.bfloat16), stream)
    _raise_on(err, "min-max")
    minmax_complement.launches += 1


def _check_frames(x):
    if x.ndim != 4:
        raise ValueError(f"expected [B, H, W, C] frames, got "
                         f"{tuple(x.shape)}")


def minmax_complement(x):
    """[B, H, W, C] -> (normalized x, clip(1 - x, 0, 1)) in one pass, per
    frame min/max over (H, W, C) with the TPU kernel's epsilon."""
    _check_frames(x)
    if _build.on_cpu(x, "head ops"):
        return minmax_complement_plain(x)
    x = x.contiguous()
    xn, xc = torch.empty_like(x), torch.empty_like(x)
    _minmax_launch(x, xn, xc)
    return xn, xc


def paired_input(x):
    """[B, ...] -> the [2B, ...] network input (normalized, complement),
    written straight into one buffer on the card."""
    _check_frames(x)
    if _build.on_cpu(x, "head ops"):
        return torch.cat(minmax_complement_plain(x), dim=0)
    x = x.contiguous()
    out = torch.empty((2 * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _minmax_launch(x, out[:x.shape[0]], out[x.shape[0]:])
    return out


jsd_loss_fwd.launches = 0
jsd_loss_bwd.launches = 0
minmax_complement.launches = 0
