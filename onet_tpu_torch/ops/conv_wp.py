"""Width-pair-packed 3x3 convolution and its gradient
(``onet_tpu/ops/pallas_conv.py``).

The packed layout carries a per-branch [N, H, W, 64] tensor as
[N, H, W/2, 128] with lane p*64 + c for pixel parity p = w % 2. A SAME 3x3
conv on it is, per kernel row di, a centre product with Wc[di] plus an edge
product with We[di] on the cross-pair operand ae (see ``make_wc_we``).

``conv3x3_wp_raw``, ``conv3x3_wp2_raw`` and ``conv3x3_wp_dw`` keep the JAX
functions' contract. On a CPU tensor they run the plain PyTorch version
below, which repeats the JAX kernel's arithmetic (shifted operands, then
``@``). On a CUDA tensor they launch the hand-written kernel or raise;
nothing falls back. Each wrapper counts its kernel launches in ``.launches``.

The card kernels:
* ``csrc/conv_wp.cu`` replaces ``_fwd_kernel`` and ``_fwd2_kernel``
  (``onet_tpu/ops/pallas_conv.py:212,259``), with the bias+ReLU epilogue and
  the BatchNorm-stats epilogue (``stats=True``: per-sample lane sums from
  the f32 accumulator, reduced across CTAs by a deterministic second pass).
  It reads the packed tensor as the NHWC tensor it is byte for byte and runs
  the 9 real 64x64 taps, taken from Wc's blocks, instead of the 6 128x128
  products with their 25% zeros.
* ``csrc/conv_wp_dw.cu`` replaces ``_dw_kernel`` (``pallas_conv.py:457``):
  the 9 taps of the weight gradient as 64x64 products over the pixels, per
  CTA partials summed by a deterministic second pass.
Both are bound on the H100 about equally by tensor-core operations and HBM
bytes; the sources say what their designs do about each.

``conv3x3_wp`` and ``conv3x3_wp2`` are the differentiable forms
(``torch.autograd.Function``, the JAX ``custom_vjp``): forward with the
stats epilogue, dx through the forward kernel with ``flip_transpose``d
weights, dw through ``conv3x3_wp_dw``; s1 and s2 carry no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from onet_tpu_torch.ops import _build

C = 64          # per-branch channels at the packed levels
L = 2 * C       # packed lane count


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def pack_wp(x_stacked: torch.Tensor) -> torch.Tensor:
    """Channel-stacked [B, H, W, 2C] -> pair-packed [2B, H, W/2, 2C]: branch b
    lands at batch slot b*B + n, lanes become (w%2)*C + c."""
    b, h, w, c2 = x_stacked.shape
    c = c2 // 2
    xb = torch.cat([x_stacked[..., :c], x_stacked[..., c:]], dim=0)
    return xb.reshape(2 * b, h, w // 2, 2 * c)


def unpack_wp(x_wp: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_wp."""
    n2, h, wp, l = x_wp.shape
    b = n2 // 2
    c = l // 2
    xb = x_wp.reshape(n2, h, wp * 2, c)
    return torch.cat([xb[:b], xb[b:]], dim=-1)


def make_wc_we(w: torch.Tensor, dtype=torch.bfloat16):
    """[3, 3, 64, 64] HWIO -> (Wc [3, 128, 128], We [3, 128, 128]):
    Wc[di] = [[W[di,1], W[di,0]], [W[di,2], W[di,1]]],
    We[di] = [[W[di,0], 0], [0, W[di,2]]]
    (block rows = input parity, block columns = output parity)."""
    if tuple(w.shape) != (3, 3, C, C):
        raise ValueError(f"expected a [3, 3, {C}, {C}] weight, got "
                         f"{tuple(w.shape)}")
    w = w.to(dtype)
    z = torch.zeros((C, C), dtype=dtype, device=w.device)
    wc = torch.stack([
        torch.cat([torch.cat([w[di, 1], w[di, 0]], 1),
                   torch.cat([w[di, 2], w[di, 1]], 1)], 0)
        for di in range(3)])
    we = torch.stack([
        torch.cat([torch.cat([w[di, 0], z], 1),
                   torch.cat([z, w[di, 2]], 1)], 0)
        for di in range(3)])
    return wc, we


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """W'[di, dj] = W[2-di, 2-dj]^T: the weight under which the forward conv
    of dy computes the input gradient of conv(x, W)."""
    return w.flip(0, 1).transpose(2, 3)


def taps_from_wc(wc: torch.Tensor) -> torch.Tensor:
    """The nine [64, 64] taps, [3, 3, 64, 64] HWIO, read back from Wc's
    blocks (W[di,0] upper right, W[di,1] upper left, W[di,2] lower left)."""
    return torch.stack([wc[:, :C, C:], wc[:, :C, :C], wc[:, C:, :C]],
                       dim=1).contiguous()


# ---------------------------------------------------------------------------
# plain versions: the JAX kernel's arithmetic in PyTorch
# ---------------------------------------------------------------------------

def _edge_operand(x: torch.Tensor) -> torch.Tensor:
    """ae[:, :, j] = [x[:, :, j-1, C:] | x[:, :, j+1, :C]], zero past the
    image edge (the cross-pair operand of ``_build_ae``)."""
    z = torch.zeros_like(x[:, :, :1, :C])
    left = torch.cat([z, x[:, :, :-1, C:]], dim=2)
    right = torch.cat([x[:, :, 1:, :C], z], dim=2)
    return torch.cat([left, right], dim=-1)


def _conv_acc_plain(x, wc, we):
    """f32 accumulator of one packed conv: sum over kernel rows di of
    x[r+di-1] @ Wc[di] + ae[r+di-1] @ We[di]. Operands are upcast to f32,
    which keeps bf16 products exact."""
    h = x.shape[1]
    xf = x.float()
    xs = torch.nn.functional.pad(xf, (0, 0, 0, 0, 1, 1))
    ae = torch.nn.functional.pad(_edge_operand(xf), (0, 0, 0, 0, 1, 1))
    acc = None
    for di in range(3):
        t = (xs[:, di:di + h] @ wc[di].float()
             + ae[:, di:di + h] @ we[di].float())
        acc = t if acc is None else acc + t
    return acc


def _finish_plain(acc, bias, bias_relu, stats, out_dtype):
    if bias_relu:
        acc = torch.clamp_min(acc + bias.float(), 0.0)
    y = acc.to(out_dtype)
    if stats:
        return y, acc.sum(dim=(1, 2)), acc.square().sum(dim=(1, 2))
    return y


def conv3x3_wp_plain(x, wc, we, *, bias=None, bias_relu=False, stats=False,
                     out_dtype=None):
    """Plain PyTorch version of ``conv3x3_wp_raw``."""
    bias = _bias(bias, x)
    return _finish_plain(_conv_acc_plain(x, wc, we), bias, bias_relu, stats,
                         out_dtype or x.dtype)


def conv3x3_wp2_plain(xa, xb, wca, wea, wcb, web, *, bias=None,
                      bias_relu=False, stats=False, out_dtype=None):
    """Plain PyTorch version of ``conv3x3_wp2_raw``."""
    bias = _bias(bias, xa)
    acc = _conv_acc_plain(xa, wca, wea) + _conv_acc_plain(xb, wcb, web)
    return _finish_plain(acc, bias, bias_relu, stats, out_dtype or xa.dtype)


def conv3x3_wp_dw_plain(x, dy):
    """Plain PyTorch version of ``conv3x3_wp_dw``: the quadrant products
    Gc[di] = xc^T dy and Ge[di] = ae^T dy of the JAX kernel in f32, and the
    taps assembled from their quadrants (two partial sums per tap)."""
    h = x.shape[1]
    xs = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 1, 1))
    ae = torch.nn.functional.pad(_edge_operand(x.float()), (0, 0, 0, 0, 1, 1))
    d = dy.float().reshape(-1, L)
    gc = [xs[:, di:di + h].reshape(-1, L).T @ d for di in range(3)]
    ge = [ae[:, di:di + h].reshape(-1, L).T @ d for di in range(3)]
    return torch.stack([
        torch.stack([
            gc[di][:C, C:] + ge[di][:C, :C],             # dj = -1
            gc[di][:C, :C] + gc[di][C:, C:],             # dj = 0
            gc[di][C:, :C] + ge[di][C:, C:],             # dj = +1
        ]) for di in range(3)])


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the kernel on the card
# ---------------------------------------------------------------------------

def _bias(bias, x):
    if bias is None:
        return torch.zeros(L, dtype=torch.float32, device=x.device)
    return bias.reshape(L).float()


def _check(xs, ws):
    x0 = xs[0]
    if x0.ndim != 4 or x0.shape[-1] != L:
        raise ValueError(f"expected a packed [N, H, Wp, {L}] input, got "
                         f"{tuple(x0.shape)}")
    for x in xs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(f"inputs differ: {tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(x0.shape)} {x0.dtype}")
    for w in ws:
        if tuple(w.shape) != (3, L, L):
            raise ValueError(f"expected a [3, {L}, {L}] packed weight, got "
                             f"{tuple(w.shape)}")


_DTYPES = (torch.bfloat16, torch.float32)


def _aligned(*ts):
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("conv_wp kernels need 16-byte aligned tensors")


def _launch(xs, taps, bias, bias_relu, stats, out_dtype):
    """Run csrc/conv_wp.cu on CUDA tensors with the per-input [3, 3, 64, 64]
    taps; returns y [N, H, Wp, 128], and with ``stats`` also (s1, s2)
    [N, 128] f32. Counts the launch on the wrapper of its arity."""
    x0 = xs[0]
    dev = x0.device
    if x0.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"conv_wp kernel takes bf16 or f32, got {x0.dtype} "
                        f"-> {out_dtype}")
    for t in taps:
        if t.device != dev or t.dtype != x0.dtype or \
                tuple(t.shape) != (3, 3, C, C):
            raise ValueError("taps must be [3, 3, 64, 64] on the input's "
                             f"device and in its dtype ({dev}, {x0.dtype}); "
                             f"got {tuple(t.shape)} {t.device} {t.dtype}")
    xs = [x.contiguous() for x in xs]
    taps = [t.contiguous() for t in taps]
    b = _bias(bias, x0).to(dev).contiguous()
    n, h, wp, _ = x0.shape
    y = torch.empty((n, h, wp, L), dtype=out_dtype, device=dev)
    _aligned(*xs, *taps, b, y)
    if stats:
        # per-tile partials of the first pass: 8-row x 32-pixel tiles
        tiles = n * -(-h // 8) * -(-(2 * wp) // 32)
        part = torch.empty((tiles, 2 * L), dtype=torch.float32, device=dev)
        s1 = torch.zeros((n, L), dtype=torch.float32, device=dev)
        s2 = torch.zeros((n, L), dtype=torch.float32, device=dev)
        ptrs = (part.data_ptr(), s1.data_ptr(), s2.data_ptr())
    else:
        ptrs = (0, 0, 0)
    lib = _build.load("conv_wp")
    fn = lib.onet_conv3x3_wp
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x1 = xs[1] if len(xs) > 1 else xs[0]
    t1 = taps[1] if len(taps) > 1 else taps[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xs[0].data_ptr(), x1.data_ptr(), taps[0].data_ptr(),
                 t1.data_ptr(), b.data_ptr(), y.data_ptr(), *ptrs, n, h,
                 2 * wp, len(xs), int(x0.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), int(bool(bias_relu)),
                 int(bool(stats)), stream)
    if err:
        raise RuntimeError(f"conv_wp kernel launch failed: CUDA error {err}")
    counted = conv3x3_wp_raw if len(xs) == 1 else conv3x3_wp2_raw
    counted.launches += 1
    counted.stats_launches += bool(stats)
    return (y, s1, s2) if stats else y


@functools.cache
def _dw_lib():
    """csrc/conv_wp_dw.cu's two C functions, their signatures set once."""
    lib = _build.load("conv_wp_dw")
    blocks = lib.onet_conv3x3_wp_dw_blocks
    blocks.argtypes = [ctypes.c_int] * 4
    blocks.restype = ctypes.c_int
    fn = lib.onet_conv3x3_wp_dw
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return blocks, fn


@functools.cache
def _dw_blocks(device_index: int, n: int, h: int, w: int, bf16: int) -> int:
    """The kernel's set-up on one card, once per shape and dtype: its
    shared-memory attribute, and the number of CTA partials (raises on a
    CUDA error, which is then not cached)."""
    with torch.cuda.device(device_index):
        nblk = _dw_lib()[0](n, h, w, bf16)
    if nblk < 0:
        raise RuntimeError(f"conv_wp_dw kernel setup failed: CUDA error "
                           f"{-nblk}")
    return nblk


def _launch_dw(x, dy):
    """Run csrc/conv_wp_dw.cu on CUDA tensors; returns dw [3, 3, 64, 64]."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_wp_dw kernel takes bf16 or f32, got {x.dtype}")
    dev = x.device
    n, h, wp, _ = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    nblk = _dw_blocks(index, n, h, 2 * wp, bf16)
    fn = _dw_lib()[1]
    with torch.cuda.device(dev):
        part = torch.empty((nblk, 3, 3, C, C), dtype=torch.float32,
                           device=dev)
        dw = torch.empty((3, 3, C, C), dtype=torch.float32, device=dev)
        _aligned(x, dy, part, dw)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                 dw.data_ptr(), n, h, 2 * wp, bf16, nblk, stream)
    if err:
        raise RuntimeError(f"conv_wp_dw kernel launch failed: CUDA error "
                           f"{err}")
    return dw



def conv3x3_wp_raw(x, wc, we, *, bias=None, bias_relu: bool = False,
                   stats: bool = False, out_dtype=None):
    """Pair-packed SAME 3x3 conv.

    x: [N, H, Wp, 128] packed; wc/we: [3, 128, 128] from make_wc_we in x's
    dtype. Returns y [N, H, Wp, 128] (out_dtype, default x.dtype); with
    ``stats=True`` also the per-sample f32 lane sums (s1, s2), each
    [N, 128], of the stored value before its cast (sum and sum of squares
    over that sample's pixels). ``bias_relu=True`` stores
    max(acc + bias, 0), ``bias`` a [128] packed vector; without it the bias
    is not added, as in the JAX kernel."""
    _check([x], [wc, we])
    out_dtype = out_dtype or x.dtype
    if _build.on_cpu(x, "conv_wp"):
        return conv3x3_wp_plain(x, wc, we, bias=bias, bias_relu=bias_relu,
                                stats=stats, out_dtype=out_dtype)
    return _launch([x], [taps_from_wc(wc)], bias, bias_relu, stats,
                   out_dtype)


def conv3x3_wp2_raw(xa, xb, wca, wea, wcb, web, *, bias=None,
                    bias_relu: bool = False, stats: bool = False,
                    out_dtype=None):
    """Two-input pair-packed conv y = conv(xa, wa) + conv(xb, wb): the
    decoder's concat(skip, up) conv without building the concat. Same
    contract as conv3x3_wp_raw."""
    _check([xa, xb], [wca, wea, wcb, web])
    out_dtype = out_dtype or xa.dtype
    if _build.on_cpu(xa, "conv_wp"):
        return conv3x3_wp2_plain(xa, xb, wca, wea, wcb, web, bias=bias,
                                 bias_relu=bias_relu, stats=stats,
                                 out_dtype=out_dtype)
    return _launch([xa, xb], [taps_from_wc(wca), taps_from_wc(wcb)], bias,
                   bias_relu, stats, out_dtype)


def conv3x3_wp_dw(x, dy):
    """Weight gradient of the pair-packed conv: x, dy packed
    [N, H, Wp, 128] of one dtype -> dw [3, 3, 64, 64] f32 (HWIO), summed
    over the batch (branches ride the batch, so weight sharing is
    automatic)."""
    _check([x, dy], [])
    if _build.on_cpu(x, "conv_wp"):
        return conv3x3_wp_dw_plain(x, dy)
    if dy.device != x.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    dw = _launch_dw(x.contiguous(), dy.contiguous())
    conv3x3_wp_dw.launches += 1
    return dw


# kernel launches; stats_launches counts those with the stats epilogue
conv3x3_wp_raw.launches = conv3x3_wp_raw.stats_launches = 0
conv3x3_wp2_raw.launches = conv3x3_wp2_raw.stats_launches = 0
conv3x3_wp_dw.launches = 0


# ---------------------------------------------------------------------------
# differentiable forms (the JAX custom_vjp)
# ---------------------------------------------------------------------------

def _conv_w(xs, ws, stats=False):
    """The conv of the differentiable forms on [3, 3, 64, 64] weights: on
    the CPU the plain version through Wc/We, as the JAX function computes
    it; on the card the kernel on the taps themselves."""
    _check(xs, [])
    x = xs[0]
    if _build.on_cpu(x, "conv_wp"):
        wcs = [m for w in ws for m in make_wc_we(w, dtype=x.dtype)]
        plain = conv3x3_wp_plain if len(xs) == 1 else conv3x3_wp2_plain
        return plain(*xs, *wcs, stats=stats)
    return _launch(xs, [w.to(x.dtype) for w in ws], None, False, stats,
                   x.dtype)


class _ConvWp(torch.autograd.Function):
    """(x, w) -> (y, s1, s2) with the stats epilogue; s1/s2 feed the
    BatchNorm EMA and the precomputed-stats apply, both gradient-free."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = _conv_w([x], [w], stats=True)
        ctx.save_for_backward(x, w)
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_w([dy], [flip_transpose(w)])
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wp_dw(x, dy).to(w.dtype)
        return dx, dw


class _ConvWp2(torch.autograd.Function):
    """(xa, xb, wa, wb) -> (y, s1, s2), y = conv(xa, wa) + conv(xb, wb)."""

    @staticmethod
    def forward(ctx, xa, xb, wa, wb):
        y, s1, s2 = _conv_w([xa, xb], [wa, wb], stats=True)
        ctx.save_for_backward(xa, xb, wa, wb)
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):
        xa, xb, wa, wb = ctx.saved_tensors
        dy = dy.to(xa.dtype).contiguous()
        grads = [None] * 4
        for i, (x, w) in enumerate(((xa, wa), (xb, wb))):
            if ctx.needs_input_grad[i]:
                grads[i] = _conv_w([dy], [flip_transpose(w)])
            if ctx.needs_input_grad[2 + i]:
                grads[2 + i] = conv3x3_wp_dw(x, dy).to(w.dtype)
        return tuple(grads)


def conv3x3_wp(x, w):
    """Differentiable pair-packed SAME 3x3 conv with the fused BN stats.

    x: packed [N, H, Wp, 128]; w: [3, 3, 64, 64] HWIO per-branch weight,
    products in x.dtype with f32 accumulation. Returns (y, s1, s2): y in
    x.dtype, s1/s2 the per-sample f32 lane sums of y (no gradient)."""
    return _ConvWp.apply(x, w)


def conv3x3_wp2(xa, xb, wa, wb):
    """Differentiable two-input form: y = conv(xa, wa) + conv(xb, wb), the
    decoder conv over concat(skip, up) without the concat; wa/wb are the
    [3, 3, 128, 64] weight split at input channel 64. Returns (y, s1, s2)
    like conv3x3_wp."""
    return _ConvWp2.apply(xa, xb, wa, wb)
