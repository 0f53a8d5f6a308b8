"""int8 convolutions with an int32 accumulator and a fused dequantize /
requantize epilogue: the int8 serving graph's and int8 training's convs.

They stand where the JAX package calls XLA's int8 ops, which PyTorch lacks
on the card (``F.conv2d`` refuses int8):

* ``conv3x3_i8``: ``lax.conv_general_dilated(int8, int8 -> int32)``, 3x3
  SAME, stride 1 (``onet_tpu/models/quant.py:257-263``,
  ``qtrain.py:69-72,116-121``). x [N, H, W, ci] int8, w [3, 3, ci, co] int8
  HWIO.
* ``convT2x2_i8``: ``lax.conv_transpose(int8, int8 -> int32)``, kernel 2,
  stride 2, VALID (``quant.py:307-315``). w is the pre-reversed kernel
  ``quantize_folded`` stores (``lax.conv_transpose``'s argument), so
  y[n, 2i+di, 2j+dj, o] = sum_c x[n, i, j, c] w[1-di, 1-dj, c, o].

Epilogue, per output channel o, with ``scale`` (and ``bias``) f32 [co]:
``scale=None`` returns the int32 accumulator; else y = acc * scale[o]
(+ bias[o]) in f32, rounded after each operation, and with ``requant``
the codes clamp(round(y / s_next[o]), lo, 127) as int8, lo = 0
("unsigned", post-ReLU) or -127 ("signed"); round is half to even, as
``jnp.round``.

On a CPU tensor the wrappers run the plain versions below: the accumulator
in float64 on the codes (exact while |acc| < 2^53; float32 is not, 9 ci
127^2 passes 2^24 from ci = 128), rounded to int32, then the same
epilogue in PyTorch. On a CUDA tensor they launch ``csrc/conv_i8.cu`` or
raise; the kernel's epilogue rounds as the plain version does, so its
codes are bit-equal. Each wrapper counts its kernel launches in
``.launches``.

The wrappers call two ``torch.library`` custom ops,
``onet_tpu_torch::conv3x3_i8`` and ``onet_tpu_torch::convT2x2_i8``, with
a fake implementation for tracing: ``torch.export`` records them as ops,
so an exported int8 program launches the kernels. Importing this module
registers them; ``serve/artifact.py`` imports it before it loads an int8
program.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from onet_tpu_torch.ops import _build

QMAX = 127.0
KPAD = 64                     # the kernel's K step, bytes
# the out modes, as the kernel takes them: int32 acc, f32, unsigned and
# signed int8 codes
OUT_I32, OUT_F32, OUT_U8, OUT_S8 = range(4)
_REQUANT = {None: OUT_F32, "unsigned": OUT_U8, "signed": OUT_S8}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def conv3x3_acc_plain(x, w):
    """int32 accumulator of the 3x3 SAME conv of int8 codes, exact."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 w.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)


def convT2x2_acc_plain(x, w):
    """int32 accumulator of the 2x2 stride-2 transposed conv, w the
    pre-reversed kernel, exact."""
    y = F.conv_transpose2d(x.double().permute(0, 3, 1, 2),
                           w.flip(0, 1).double().permute(2, 3, 0, 1),
                           stride=2)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)


def out_mode(scale, requant) -> int:
    """The out mode of a call with ``scale`` and ``requant``."""
    return OUT_I32 if scale is None else _REQUANT[requant]


def epilogue_plain(acc, scale, bias, s_next, mode: int):
    """The kernels' epilogue on an int32 accumulator (see the module
    docstring); divisions by tensors, so every device rounds alike."""
    if mode == OUT_I32:
        return acc
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    if mode == OUT_F32:
        return y
    lo = 0.0 if mode == OUT_U8 else -QMAX
    return torch.clamp(torch.round(y / s_next), lo, QMAX).to(torch.int8)


def plain(x, w, scale, bias, s_next, mode: int, convt: bool):
    """The plain version of one launch, operands as the kernel takes them."""
    acc = (convT2x2_acc_plain if convt else conv3x3_acc_plain)(x, w)
    return epilogue_plain(acc, scale, bias, s_next, mode)


def conv3x3_i8_plain(x, w, scale=None, bias=None, *, requant=None,
                     s_next=None):
    """Plain version of ``conv3x3_i8``."""
    return plain(x, w, scale, bias, s_next, out_mode(scale, requant), False)


def convT2x2_i8_plain(x, w, scale=None, bias=None, *, requant=None,
                      s_next=None):
    """Plain version of ``convT2x2_i8``."""
    return plain(x, w, scale, bias, s_next, out_mode(scale, requant), True)


# ---------------------------------------------------------------------------
# the kernel's operands
# ---------------------------------------------------------------------------

def _check(x, w, convt, scale, bias, requant, s_next):
    kh = 2 if convt else 3
    name = "convT2x2_i8" if convt else "conv3x3_i8"
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 codes, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (kh, kh) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x [N, H, W, ci] and w [{kh}, {kh}, ci, "
                         f"co], got {tuple(x.shape)} and {tuple(w.shape)}")
    if requant not in _REQUANT:
        raise ValueError(f"requant must be None, 'unsigned' or 'signed', not "
                         f"{requant!r}")
    if (requant is None) != (s_next is None) or (scale is None and (
            requant is not None or bias is not None)):
        raise ValueError(f"{name}: s_next goes with requant, and requant and "
                         "bias need a scale")
    co = w.shape[3]
    for t in (scale, bias, s_next):
        if t is not None and (t.shape != (co,) or t.dtype != torch.float32):
            raise ValueError(f"{name}: scale, bias and s_next are f32 [{co}], "
                             f"got {t.dtype} {tuple(t.shape)}")


def _out_dtype(mode: int):
    return (torch.int32, torch.float32, torch.int8, torch.int8)[mode]


def _out_shape(x, w, convt) -> tuple:
    n, h, wd, _ = x.shape
    return (n, 2 * h, 2 * wd, w.shape[3]) if convt else (n, h, wd,
                                                         w.shape[3])


def operands(x, w, convt: bool) -> tuple:
    """(x, B, ci, kpad, vec) as the kernel reads them: x NHWC contiguous
    with ci padded by zero codes to a multiple of 4 where it is not one of
    16; B [cols, kpad] int8, K contiguous and padded by zero codes to a
    multiple of 64 (3x3: B[co][(tap, c)] = w[tap, c, co]; convT:
    B[(di, dj, co)][c] = w[1-di, 1-dj, c, co]). One copy of the weights a
    call."""
    ci = x.shape[3]
    vec = 16 if ci % 16 == 0 else 4
    cip = -(-ci // vec) * vec
    if cip != ci:
        x = F.pad(x, (0, cip - ci))
        w = F.pad(w, (0, 0, 0, cip - ci))
    x = x.contiguous()
    if convt:
        b = w.flip(0, 1).permute(0, 1, 3, 2).reshape(-1, cip)
    else:
        b = w.permute(3, 0, 1, 2).reshape(w.shape[3], -1)
    kpad = -(-b.shape[1] // KPAD) * KPAD
    b = F.pad(b, (0, kpad - b.shape[1])).contiguous()
    return x, b, cip, kpad, vec


@functools.cache
def _lib():
    """csrc/conv_i8.cu's C function, its signature set once."""
    fn = _build.load("conv_i8").onet_conv_i8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel(xk, b, vec, kpad, co, scale, bias, s_next, mode, convt):
    """One launch of csrc/conv_i8.cu on operands laid out by ``operands``
    (CUDA tensors); returns y. Not counted: the wrappers count."""
    dev = xk.device
    for t in (b, scale, bias, s_next):
        if t is not None and t.device != dev:
            raise ValueError(f"conv_i8 operands on {t.device} and {dev}")
    if xk.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("conv_i8 kernel needs 16-byte aligned operands")
    n, h, wd, cip = xk.shape
    shape = (n, 2 * h, 2 * wd, co) if convt else (n, h, wd, co)
    y = torch.empty(shape, dtype=_out_dtype(mode), device=dev)
    vecs = [None if t is None else t.contiguous() for t in (scale, bias,
                                                              s_next)]
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(xk.data_ptr(), b.data_ptr(), *map(ptr, vecs),
                     y.data_ptr(), n, h, wd, cip, co, kpad, int(convt), vec,
                     mode, stream)
    if err:
        raise RuntimeError(f"conv_i8 kernel launch failed: CUDA error {err}")
    return y


def _launch(x, w, scale, bias, s_next, mode, convt):
    """Lay out the operands and run csrc/conv_i8.cu on CUDA tensors."""
    xk, b, _, kpad, vec = operands(x, w, convt)
    if xk.data_ptr() % 16:
        xk = xk.clone()
    return kernel(xk, b, vec, kpad, w.shape[3], scale, bias, s_next, mode,
                  convt)


# ---------------------------------------------------------------------------
# custom ops and wrappers
# ---------------------------------------------------------------------------

_SCHEMA = ("(Tensor x, Tensor w, Tensor? scale, Tensor? bias, "
           "Tensor? s_next, int mode) -> Tensor")


def _run(convt, x, w, scale, bias, s_next, mode):
    name = "convT2x2_i8" if convt else "conv3x3_i8"
    if _build.on_cpu(x, name):
        return plain(x, w, scale, bias, s_next, mode, convt)
    y = _launch(x, w, scale, bias, s_next, mode, convt)
    (convT2x2_i8 if convt else conv3x3_i8).launches += 1
    return y


@torch.library.custom_op("onet_tpu_torch::conv3x3_i8", mutates_args=(),
                         schema=_SCHEMA)
def _conv3x3_op(x, w, scale, bias, s_next, mode):
    return _run(False, x, w, scale, bias, s_next, mode)


@torch.library.custom_op("onet_tpu_torch::convT2x2_i8", mutates_args=(),
                         schema=_SCHEMA)
def _convT2x2_op(x, w, scale, bias, s_next, mode):
    return _run(True, x, w, scale, bias, s_next, mode)


@_conv3x3_op.register_fake
def _(x, w, scale, bias, s_next, mode):
    return x.new_empty(_out_shape(x, w, False), dtype=_out_dtype(mode))


@_convT2x2_op.register_fake
def _(x, w, scale, bias, s_next, mode):
    return x.new_empty(_out_shape(x, w, True), dtype=_out_dtype(mode))


def conv3x3_i8(x, w, scale=None, bias=None, *, requant=None, s_next=None):
    """int8 3x3 SAME conv: x [N, H, W, ci] int8, w [3, 3, ci, co] int8 ->
    int32 acc (``scale=None``), f32 acc * scale (+ bias), or with
    ``requant`` ("unsigned" / "signed") its int8 codes at ``s_next``."""
    _check(x, w, False, scale, bias, requant, s_next)
    return torch.ops.onet_tpu_torch.conv3x3_i8(x, w, scale, bias, s_next,
                                               out_mode(scale, requant))


def convT2x2_i8(x, w, scale=None, bias=None, *, requant=None, s_next=None):
    """int8 2x2 stride-2 transposed conv: x [N, h, w, ci] int8, w
    [2, 2, ci, co] int8 pre-reversed -> [N, 2h, 2w, co], epilogue as
    ``conv3x3_i8``'s."""
    _check(x, w, True, scale, bias, requant, s_next)
    return torch.ops.onet_tpu_torch.convT2x2_i8(x, w, scale, bias, s_next,
                                                out_mode(scale, requant))


conv3x3_i8.launches = 0
convT2x2_i8.launches = 0
