"""Width-pair-packed 3x3 convolution (``onet_tpu/ops/pallas_conv.py``).

The packed layout carries a per-branch [N, H, W, 64] tensor as
[N, H, W/2, 128] with lane p*64 + c for pixel parity p = w % 2. A SAME 3x3
conv on it is, per kernel row di, a centre product with Wc[di] plus an edge
product with We[di] on the cross-pair operand ae (see ``make_wc_we``).

``conv3x3_wp_raw`` and ``conv3x3_wp2_raw`` keep the JAX functions'
contract. On a CPU tensor they run the plain PyTorch version below, which
repeats the JAX kernel's arithmetic (shifted operands, then ``@``). On a CUDA
tensor they launch the hand-written kernel of ``csrc/conv_wp.cu`` or raise;
nothing falls back. Each wrapper counts its kernel launches in ``.launches``.

The card kernel replaces ``_fwd_kernel`` and ``_fwd2_kernel``
(``onet_tpu/ops/pallas_conv.py:212,259``). It reads the packed tensor as the
NHWC tensor it is byte for byte and runs the 9 real 64x64 taps, taken from
Wc's blocks, instead of the 6 128x128 products with their 25% zeros. It is
bound on the H100 about equally by tensor-core operations and HBM bytes;
``csrc/conv_wp.cu`` says what its design does about each. The BatchNorm-stats
epilogue (``stats=True``) is training work and runs only in the plain version.
"""

from __future__ import annotations

import ctypes

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


def _launch(xs, wcs, bias, bias_relu, stats, out_dtype):
    """Run csrc/conv_wp.cu on CUDA tensors; returns y [N, H, Wp, 128]."""
    if stats:
        raise NotImplementedError(
            "stats=True (the BatchNorm-statistics epilogue) is not in the "
            "CUDA kernel yet: it comes with the training slice of the port")
    x0 = xs[0]
    dev = x0.device
    if x0.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"conv_wp kernel takes bf16 or f32, got {x0.dtype} "
                        f"-> {out_dtype}")
    for w in wcs:
        if w.device != dev or w.dtype != x0.dtype:
            raise ValueError("weights must match the input's device and "
                             f"dtype ({dev}, {x0.dtype}); got {w.device}, "
                             f"{w.dtype}")
    xs = [x.contiguous() for x in xs]
    taps = [taps_from_wc(w) for w in wcs]
    b = _bias(bias, x0).to(dev).contiguous()
    n, h, wp, _ = x0.shape
    y = torch.empty((n, h, wp, L), dtype=out_dtype, device=dev)
    for t in (*xs, *taps, b, y):
        if t.data_ptr() % 16:
            raise ValueError("conv_wp kernel needs 16-byte aligned tensors")
    lib = _build.load("conv_wp")
    fn = lib.onet_conv3x3_wp
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x1 = xs[1] if len(xs) > 1 else xs[0]
    t1 = taps[1] if len(taps) > 1 else taps[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xs[0].data_ptr(), x1.data_ptr(), taps[0].data_ptr(),
                 t1.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, 2 * wp,
                 len(xs), int(x0.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), int(bool(bias_relu)),
                 stream)
    if err:
        raise RuntimeError(f"conv_wp kernel launch failed: CUDA error {err}")
    return y


def _on_cpu(x) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_wp runs on the CPU (plain) or CUDA (kernel), "
                         f"not {x.device}")
    return x.device.type == "cpu"


def conv3x3_wp_raw(x, wc, we, *, bias=None, bias_relu: bool = False,
                   stats: bool = False, out_dtype=None):
    """Pair-packed SAME 3x3 conv.

    x: [N, H, Wp, 128] packed; wc/we: [3, 128, 128] from make_wc_we in x's
    dtype. Returns y [N, H, Wp, 128] (out_dtype, default x.dtype); with
    ``stats=True`` also the per-sample f32 lane sums (s1, s2), each
    [N, 128] (plain version only). ``bias_relu=True`` stores
    max(acc + bias, 0), ``bias`` a [128] packed vector; without it the bias
    is not added, as in the JAX kernel."""
    _check([x], [wc, we])
    out_dtype = out_dtype or x.dtype
    if _on_cpu(x):
        return conv3x3_wp_plain(x, wc, we, bias=bias, bias_relu=bias_relu,
                                stats=stats, out_dtype=out_dtype)
    y = _launch([x], [wc], bias, bias_relu, stats, out_dtype)
    conv3x3_wp_raw.launches += 1
    return y


def conv3x3_wp2_raw(xa, xb, wca, wea, wcb, web, *, bias=None,
                    bias_relu: bool = False, stats: bool = False,
                    out_dtype=None):
    """Two-input pair-packed conv y = conv(xa, wa) + conv(xb, wb): the
    decoder's concat(skip, up) conv without building the concat. Same
    contract as conv3x3_wp_raw."""
    _check([xa, xb], [wca, wea, wcb, web])
    out_dtype = out_dtype or xa.dtype
    if _on_cpu(xa):
        return conv3x3_wp2_plain(xa, xb, wca, wea, wcb, web, bias=bias,
                                 bias_relu=bias_relu, stats=stats,
                                 out_dtype=out_dtype)
    y = _launch([xa, xb], [wca, wcb], bias, bias_relu, stats, out_dtype)
    conv3x3_wp2_raw.launches += 1
    return y


conv3x3_wp_raw.launches = 0
conv3x3_wp2_raw.launches = 0
