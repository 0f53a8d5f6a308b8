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
``jnp.round``. ``requant=("unsigned", "unsigned")`` with ``s_next=(s_a,
s_b)`` returns both unsigned code tensors of one accumulator, each equal
to the "unsigned" call at its scale: the sites whose output feeds both a
skip and the next conv (``models/quant.py``).

On a CPU tensor the wrappers run the plain versions below: the accumulator
in float64 on the codes (exact while |acc| < 2^53; float32 is not, 9 ci
127^2 passes 2^24 from ci = 128), rounded to int32, then the same
epilogue in PyTorch. On a CUDA tensor they launch ``csrc/conv_i8.cu`` or
raise; the kernel's epilogue rounds as the plain version does, so its
codes are bit-equal. Each wrapper counts its kernel launches in
``.launches`` (a two-code launch counts once).

The wrappers call four ``torch.library`` custom ops,
``onet_tpu_torch::conv3x3_i8`` and ``onet_tpu_torch::convT2x2_i8`` and
their two-code forms ``..._x2``, with a fake implementation for tracing:
``torch.export`` records them as ops, so an exported int8 program
launches the kernels. Importing this module registers them;
``serve/artifact.py`` imports it before it loads an int8 program.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from onet_tpu_torch.ops import _build

QMAX = 127.0
# the out modes, as the kernel takes them: int32 acc, f32, unsigned and
# signed int8 codes, two unsigned code tensors at two scales
OUT_I32, OUT_F32, OUT_U8, OUT_S8, OUT_U8X2 = range(5)
PAIR = ("unsigned", "unsigned")
_REQUANT = {None: OUT_F32, "unsigned": OUT_U8, "signed": OUT_S8,
            PAIR: OUT_U8X2}
# the kernel's tile: pixels x columns
BM = BN = 128


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
    docstring); divisions by tensors, so every device rounds alike. For
    ``OUT_U8X2`` ``s_next`` is a pair and so is the result."""
    if mode == OUT_U8X2:
        return tuple(epilogue_plain(acc, scale, bias, s, OUT_U8)
                     for s in s_next)
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
# the kernel's plan and operands
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """How csrc/conv_i8.cu runs one call: x's channels padded to ``cip``,
    K steps of ``ck`` bytes (the swizzle), pixel tiles of ``bh`` rows x
    ``bw`` columns of one image (``tx`` x ``ty`` an image), ``ntn``
    column tiles of 128, ``grid`` tiles in all (the persistent kernel
    walks them with at most two CTAs an SM); B is [``ncols``,
    ``kpad``]."""
    cip: int
    ck: int
    bw: int
    bh: int
    tx: int
    ty: int
    ncols: int
    ntn: int
    kpad: int
    grid: int


def plan(n: int, h: int, w: int, ci: int, co: int, convt: bool,
         ck: int | None = None) -> Plan:
    """The kernel's plan at x [n, h, w, ci] and co output channels. ci is
    padded with zero codes to 32 or a multiple of 64 (TMA wants 16-byte
    strides; each K step is a whole swizzle row); the K step is 128 bytes
    where cip allows, else 64 or 32 (``ck`` forces one cip allows). A tile
    is 128 pixels: bw the power of two at or above w, up to 128."""
    cip = 32 if ci <= 32 else -(-ci // 64) * 64
    if ck is None:
        ck = 128 if cip % 128 == 0 else 64 if cip % 64 == 0 else 32
    if ck not in (32, 64, 128) or cip % ck:
        raise ValueError(f"conv_i8: K step {ck} does not divide ci {cip}")
    bw = min(BM, 1 << max(0, (w - 1).bit_length()))
    bh = BM // bw
    tx, ty = -(-w // bw), -(-h // bh)
    ncols = 4 * co if convt else co
    ntn = -(-ncols // BN)
    return Plan(cip=cip, ck=ck, bw=bw, bh=bh, tx=tx, ty=ty, ncols=ncols,
                ntn=ntn, kpad=cip * (1 if convt else 9),
                grid=n * tx * ty * ntn)


def _check(x, w, convt, scale, bias, requant, s_next):
    kh = 2 if convt else 3
    name = "convT2x2_i8" if convt else "conv3x3_i8"
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 codes, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (kh, kh) or \
            w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x [N, H, W, ci] and w [{kh}, {kh}, ci, "
                         f"co], got {tuple(x.shape)} and {tuple(w.shape)}")
    if not isinstance(requant, (str, tuple, type(None))) or \
            requant not in _REQUANT:
        raise ValueError(f"requant must be None, 'unsigned', 'signed' or "
                         f"{PAIR}, not {requant!r}")
    pair = requant == PAIR
    if (requant is None) != (s_next is None) or (scale is None and (
            requant is not None or bias is not None)) or (
            pair != isinstance(s_next, (tuple, list))) or (
            pair and len(s_next) != 2):
        raise ValueError(f"{name}: s_next goes with requant (a pair with "
                         f"{PAIR}), and requant and bias need a scale")
    co = w.shape[3]
    for t in (scale, bias, *(s_next if pair else (s_next,))):
        if t is not None and (t.shape != (co,) or t.dtype != torch.float32):
            raise ValueError(f"{name}: scale, bias and s_next are f32 [{co}], "
                             f"got {t.dtype} {tuple(t.shape)}")


def _out_dtype(mode: int):
    return (torch.int32, torch.float32, torch.int8, torch.int8,
            torch.int8)[mode]


def _out_shape(x, w, convt) -> tuple:
    n, h, wd, _ = x.shape
    return (n, 2 * h, 2 * wd, w.shape[3]) if convt else (n, h, wd,
                                                         w.shape[3])


def operands(x, w, convt: bool, ck: int | None = None) -> tuple:
    """(x, B, plan) as the kernel reads them: x NHWC contiguous with ci
    padded by zero codes to the plan's cip; B [cols, kpad] int8, K
    contiguous (3x3: B[co][(tap, c)] = w[tap, c, co], kpad = 9 cip;
    convT: B[(di, dj, co)][c] = w[1-di, 1-dj, c, co], kpad = cip). One
    copy of the weights a call."""
    n, h, wd, ci = x.shape
    p = plan(n, h, wd, ci, w.shape[3], convt, ck)
    if p.cip != ci:
        x = F.pad(x, (0, p.cip - ci))
        w = F.pad(w, (0, 0, 0, p.cip - ci))
    x = x.contiguous()
    if convt:
        b = w.flip(0, 1).permute(0, 1, 3, 2).reshape(-1, p.cip)
    else:
        b = w.permute(3, 0, 1, 2).reshape(w.shape[3], -1)
    return x, b.contiguous(), p


@functools.cache
def _lib():
    """csrc/conv_i8.cu's C function, its signature set once."""
    fn = _build.load("conv_i8").onet_conv_i8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy(ck: int, convt: bool) -> int:
    """CTAs of the kernel an SM holds on the current card (the design
    wants 2)."""
    fn = _build.load("conv_i8").onet_conv_i8_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    got = fn(ck, int(convt))
    if got < 0:
        raise RuntimeError(f"conv_i8 occupancy query: CUDA error {-got}")
    return got


def kernel(xk, b, p: Plan, co, scale, bias, s_next, mode, convt):
    """One launch of csrc/conv_i8.cu on operands laid out by ``operands``
    (CUDA tensors); returns y, or (y, y2) for ``OUT_U8X2``. Not counted:
    the wrappers count."""
    dev = xk.device
    pair = tuple(s_next) if mode == OUT_U8X2 else (s_next, None)
    for t in (b, scale, bias, *pair):
        if t is not None and t.device != dev:
            raise ValueError(f"conv_i8 operands on {t.device} and {dev}")
    n, h, wd, cip = xk.shape
    if cip != p.cip or tuple(b.shape) != (p.ncols, p.kpad):
        raise ValueError(f"conv_i8 operands {tuple(xk.shape)}, "
                         f"{tuple(b.shape)} off the plan {p}")
    if xk.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("conv_i8 kernel needs 16-byte aligned operands")
    shape = (n, 2 * h, 2 * wd, co) if convt else (n, h, wd, co)
    ys = [torch.empty(shape, dtype=_out_dtype(mode), device=dev)
          for _ in range(2 if mode == OUT_U8X2 else 1)]
    vecs = [None if t is None else t.contiguous()
            for t in (scale, bias, *pair)]
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(xk.data_ptr(), b.data_ptr(), *map(ptr, vecs),
                     ys[0].data_ptr(), ptr(ys[-1] if len(ys) > 1 else None),
                     n, h, wd, cip, co, int(convt), p.ck, p.bw, mode, stream)
    if err:
        raise RuntimeError(f"conv_i8 kernel launch failed: CUDA error {err}")
    return tuple(ys) if mode == OUT_U8X2 else ys[0]


def _launch(x, w, scale, bias, s_next, mode, convt):
    """Lay out the operands and run csrc/conv_i8.cu on CUDA tensors."""
    xk, b, p = operands(x, w, convt)
    if xk.data_ptr() % 16:
        xk = xk.clone()
    if b.data_ptr() % 16:
        b = b.clone()
    return kernel(xk, b, p, w.shape[3], scale, bias, s_next, mode, convt)


# ---------------------------------------------------------------------------
# custom ops and wrappers
# ---------------------------------------------------------------------------

_SCHEMA = ("(Tensor x, Tensor w, Tensor? scale, Tensor? bias, "
           "Tensor? s_next, int mode) -> Tensor")
_SCHEMA_X2 = ("(Tensor x, Tensor w, Tensor scale, Tensor? bias, "
              "Tensor s_a, Tensor s_b) -> (Tensor, Tensor)")


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


@torch.library.custom_op("onet_tpu_torch::conv3x3_i8_x2", mutates_args=(),
                         schema=_SCHEMA_X2)
def _conv3x3_x2_op(x, w, scale, bias, s_a, s_b):
    return _run(False, x, w, scale, bias, (s_a, s_b), OUT_U8X2)


@torch.library.custom_op("onet_tpu_torch::convT2x2_i8_x2", mutates_args=(),
                         schema=_SCHEMA_X2)
def _convT2x2_x2_op(x, w, scale, bias, s_a, s_b):
    return _run(True, x, w, scale, bias, (s_a, s_b), OUT_U8X2)


@_conv3x3_op.register_fake
def _(x, w, scale, bias, s_next, mode):
    return x.new_empty(_out_shape(x, w, False), dtype=_out_dtype(mode))


@_convT2x2_op.register_fake
def _(x, w, scale, bias, s_next, mode):
    return x.new_empty(_out_shape(x, w, True), dtype=_out_dtype(mode))


@_conv3x3_x2_op.register_fake
def _(x, w, scale, bias, s_a, s_b):
    shape = _out_shape(x, w, False)
    return x.new_empty(shape), x.new_empty(shape)


@_convT2x2_x2_op.register_fake
def _(x, w, scale, bias, s_a, s_b):
    shape = _out_shape(x, w, True)
    return x.new_empty(shape), x.new_empty(shape)


def _call(convt, x, w, scale, bias, requant, s_next):
    _check(x, w, convt, scale, bias, requant, s_next)
    mode = out_mode(scale, requant)
    ops = torch.ops.onet_tpu_torch
    if mode == OUT_U8X2:
        op = ops.convT2x2_i8_x2 if convt else ops.conv3x3_i8_x2
        return op(x, w, scale, bias, *s_next)
    op = ops.convT2x2_i8 if convt else ops.conv3x3_i8
    return op(x, w, scale, bias, s_next, mode)


def conv3x3_i8(x, w, scale=None, bias=None, *, requant=None, s_next=None):
    """int8 3x3 SAME conv: x [N, H, W, ci] int8, w [3, 3, ci, co] int8 ->
    int32 acc (``scale=None``), f32 acc * scale (+ bias), or with
    ``requant`` ("unsigned" / "signed") its int8 codes at ``s_next``; with
    ``requant=("unsigned", "unsigned")`` and ``s_next=(s_a, s_b)`` the
    two unsigned code tensors."""
    return _call(False, x, w, scale, bias, requant, s_next)


def convT2x2_i8(x, w, scale=None, bias=None, *, requant=None, s_next=None):
    """int8 2x2 stride-2 transposed conv: x [N, h, w, ci] int8, w
    [2, 2, ci, co] int8 pre-reversed -> [N, 2h, 2w, co], epilogue as
    ``conv3x3_i8``'s."""
    return _call(True, x, w, scale, bias, requant, s_next)


conv3x3_i8.launches = 0
convT2x2_i8.launches = 0
