"""The hand-written CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; skips without them. This file imports no
JAX, so on the machine with the card it runs without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Shapes include ragged tiles (H not a multiple of 8, W not of 32) to cover
the kernels' edge masking. Tolerances: f32 (TF32 off) 1e-4, the
reassociation of a 576-term sum; bf16 against the plain version's f32
accumulator on the same bf16 inputs, 2e-2 of max|y|, one bf16 rounding of
the output. The stats s1/s2 and dw are sums over many pixels taken in
another order than the plain version's: they are held to 1e-5 of the
largest value in f32 and bf16 alike (the products are exact in f32 either
way; only the summation order differs), as chip_smoke.py holds them.
"""

import pytest
import torch

from onet_tpu_torch.ops import conv_bd as TB
from onet_tpu_torch.ops import conv_wp as TC
from onet_tpu_torch.ops import head as THD

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(dev, dtype, n, h, wp, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((n, h, wp, 128), generator=g).to(dev, dtype)
          for _ in range(2)]
    ws = [TC.make_wc_we(0.05 * torch.randn((3, 3, 64, 64), generator=g),
                        dtype=dtype) for _ in range(2)]
    ws = [(wc.to(dev), we.to(dev)) for wc, we in ws]
    bias = torch.randn(128, generator=g).to(dev)
    return xs, ws, bias


def _assert_close(y, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
    else:
        err = (y.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 12, 20), (1, 8, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_relu", [False, True])
def test_kernels_match_plain(dev, shape, dtype, bias_relu):
    xs, ws, bias = _inputs(dev, dtype, *shape)
    n1, n2 = TC.conv3x3_wp_raw.launches, TC.conv3x3_wp2_raw.launches
    y1 = TC.conv3x3_wp_raw(xs[0], *ws[0], bias=bias, bias_relu=bias_relu)
    y2 = TC.conv3x3_wp2_raw(xs[0], xs[1], *ws[0], *ws[1], bias=bias,
                            bias_relu=bias_relu)
    torch.cuda.synchronize()
    assert TC.conv3x3_wp_raw.launches == n1 + 1
    assert TC.conv3x3_wp2_raw.launches == n2 + 1
    r1 = TC.conv3x3_wp_plain(xs[0], *ws[0], bias=bias, bias_relu=bias_relu,
                             out_dtype=torch.float32)
    r2 = TC.conv3x3_wp2_plain(xs[0], xs[1], *ws[0], *ws[1], bias=bias,
                              bias_relu=bias_relu, out_dtype=torch.float32)
    assert y1.dtype == y2.dtype == dtype
    _assert_close(y1, r1, dtype)
    _assert_close(y2, r2, dtype)


def test_f32_output_from_bf16_inputs(dev):
    xs, ws, bias = _inputs(dev, torch.bfloat16, 2, 16, 16)
    y = TC.conv3x3_wp_raw(xs[0], *ws[0], bias=bias, bias_relu=True,
                          out_dtype=torch.float32)
    ref = TC.conv3x3_wp_plain(xs[0], *ws[0], bias=bias, bias_relu=True,
                              out_dtype=torch.float32)
    torch.testing.assert_close(y, ref, rtol=1e-3, atol=1e-3)


def _assert_sums_close(got, ref):
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 12, 20), (1, 8, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_relu", [False, True])
def test_stats_epilogue_matches_plain(dev, shape, dtype, bias_relu):
    """s1, s2 of the value after bias/ReLU, before the cast, nin 1 and 2."""
    xs, ws, bias = _inputs(dev, dtype, *shape, seed=1)
    n1, n2 = TC.conv3x3_wp_raw.launches, TC.conv3x3_wp2_raw.launches
    got = [TC.conv3x3_wp_raw(xs[0], *ws[0], bias=bias, bias_relu=bias_relu,
                             stats=True),
           TC.conv3x3_wp2_raw(xs[0], xs[1], *ws[0], *ws[1], bias=bias,
                              bias_relu=bias_relu, stats=True)]
    torch.cuda.synchronize()
    assert TC.conv3x3_wp_raw.launches == n1 + 1
    assert TC.conv3x3_wp2_raw.launches == n2 + 1
    refs = [TC.conv3x3_wp_plain(xs[0], *ws[0], bias=bias,
                                bias_relu=bias_relu, stats=True,
                                out_dtype=torch.float32),
            TC.conv3x3_wp2_plain(xs[0], xs[1], *ws[0], *ws[1], bias=bias,
                                 bias_relu=bias_relu, stats=True,
                                 out_dtype=torch.float32)]
    for (y, s1, s2), (ry, rs1, rs2) in zip(got, refs):
        assert s1.shape == s2.shape == (shape[0], 128)
        assert s1.dtype == s2.dtype == torch.float32
        _assert_close(y, ry, dtype)
        _assert_sums_close(s1, rs1)
        _assert_sums_close(s2, rs2)


@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 12, 20), (1, 8, 4),
                                   (5, 37, 72), (1, 8, 18), (3, 40, 100),
                                   (2, 520, 258)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_matches_plain(dev, shape, dtype):
    """Packed (N, H, W/2): widths of 36, 200 and 516 pixels are not a
    multiple of the bf16 kernel's 64-pixel strip, and the CTAs' row ranges
    split strips at rows that depend on the shape."""
    xs, _, _ = _inputs(dev, dtype, *shape, seed=2)
    n = TC.conv3x3_wp_dw.launches
    dw = TC.conv3x3_wp_dw(xs[0], xs[1])
    torch.cuda.synchronize()
    assert TC.conv3x3_wp_dw.launches == n + 1
    ref = TC.conv3x3_wp_dw_plain(xs[0], xs[1])
    assert dw.shape == (3, 3, 64, 64) and dw.dtype == torch.float32
    _assert_sums_close(dw, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_kernel_is_deterministic(dev, dtype):
    """Two calls on the same inputs give the same bits: per-CTA partials
    summed in CTA order, no atomics."""
    xs, _, _ = _inputs(dev, dtype, 3, 40, 100, seed=6)
    assert torch.equal(TC.conv3x3_wp_dw(xs[0], xs[1]),
                       TC.conv3x3_wp_dw(xs[0], xs[1]))


def test_dw_kernel_takes_non_contiguous_dy(dev):
    xs, _, _ = _inputs(dev, torch.bfloat16, 2, 16, 16, seed=3)
    dy = xs[1].transpose(1, 2).contiguous().transpose(1, 2)
    assert not dy.is_contiguous()
    _assert_sums_close(TC.conv3x3_wp_dw(xs[0], dy),
                       TC.conv3x3_wp_dw_plain(xs[0], xs[1]))


def test_autograd_functions_launch_the_kernels(dev):
    """One forward and backward of each differentiable form: 1 forward
    launch, one dx launch and one dw launch per input."""
    xs, _, _ = _inputs(dev, torch.bfloat16, 2, 16, 16, seed=4)
    g = torch.Generator().manual_seed(5)
    wa, wb = [(0.05 * torch.randn((3, 3, 64, 64), generator=g))
              .to(dev, torch.bfloat16).requires_grad_(True) for _ in range(2)]
    xa, xb = [x.detach().requires_grad_(True) for x in xs]
    before = (TC.conv3x3_wp_raw.launches, TC.conv3x3_wp2_raw.launches,
              TC.conv3x3_wp_dw.launches)
    y1, _, _ = TC.conv3x3_wp(xa, wa)
    y2, _, _ = TC.conv3x3_wp2(xa, xb, wa, wb)
    (y1.float().square().sum() + y2.float().sum()).backward()
    torch.cuda.synchronize()
    after = (TC.conv3x3_wp_raw.launches, TC.conv3x3_wp2_raw.launches,
             TC.conv3x3_wp_dw.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1 + 3, 1, 3)
    assert all(torch.isfinite(t.grad).all() for t in (xa, xb, wa, wb))
    # the taps route of the differentiable forms against Wc/We
    wcs = [TC.make_wc_we(w.detach(), dtype=torch.bfloat16) for w in (wa, wb)]
    _assert_close(y1, TC.conv3x3_wp_plain(xa.detach(), *wcs[0],
                                          out_dtype=torch.float32),
                  torch.bfloat16)
    _assert_close(y2, TC.conv3x3_wp2_plain(xa.detach(), xb.detach(), *wcs[0],
                                           *wcs[1], out_dtype=torch.float32),
                  torch.bfloat16)


# ---------------------------------------------------------------------------
# the JSD head, min-max and native-layout conv kernels (csrc/head.cu,
# csrc/conv_bd.cu). Head: the loss within 1e-5 relative, gradients within
# 1e-4 (f32) and 1e-2 (bf16) of each one's largest magnitude; min-max equal
# to the plain version (both IEEE f32); bd: y within 1e-4 of max|y| in f32
# and 1e-2 in bf16 (one rounding), s1/s2 as above.
# ---------------------------------------------------------------------------


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / (ref.float().abs().max() + 1e-30)).item()


@pytest.mark.parametrize("shape", [(2, 8, 16, 64), (1, 3, 5, 64),
                                   (3, 7, 11, 8), (2, 5, 5, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_kernels_match_plain(dev, shape, dtype):
    """Pixel counts that are not a multiple of the block, rows of 16-byte
    multiples (vector loads) and not (C=5 in f32, scalar loads)."""
    g = torch.Generator().manual_seed(sum(shape))
    ts = [torch.randn(shape, generator=g).to(dev, dtype).requires_grad_(True)
          for _ in range(4)]
    n_fwd, n_bwd = THD.jsd_loss_fwd.launches, THD.jsd_loss_bwd.launches
    loss = THD.fused_jsd_loss(*ts)
    grads = torch.autograd.grad(loss, ts)
    torch.cuda.synchronize()
    assert THD.jsd_loss_fwd.launches == n_fwd + 1
    assert THD.jsd_loss_bwd.launches == n_bwd + 1
    flat = [t.detach() for t in ts]
    ref = THD.jsd_loss_fwd_plain(*flat)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    npix = shape[0] * shape[1] * shape[2]
    refs = THD.jsd_loss_bwd_plain(
        *(t.float() for t in flat),
        torch.full((1,), 1.0 / (2 * npix), device=dev))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for gr, r in zip(grads, refs):
        assert gr.dtype == dtype and gr.shape == shape
        assert _rel(gr, r) <= tol


@pytest.mark.parametrize("shape", [(3, 37, 53, 1), (2, 64, 70, 3),
                                   (1, 512, 512, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minmax_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator().manual_seed(shape[1])
    x = (5 * torch.rand(shape, generator=g) - 1).to(dev, dtype)
    n = THD.minmax_complement.launches
    xn, xc = THD.minmax_complement(x)
    pair = THD.paired_input(x)
    torch.cuda.synchronize()
    assert THD.minmax_complement.launches == n + 2
    rn, rc = THD.minmax_complement_plain(x)
    assert xn.dtype == xc.dtype == dtype
    assert torch.equal(xn, rn) and torch.equal(xc, rc)
    assert torch.equal(pair, torch.cat([rn, rc]))


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 12, 20), (3, 9, 37)])
@pytest.mark.parametrize("nin", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bd_kernel_matches_plain(dev, shape, nin, dtype):
    """H and W not multiples of the 8x32 tile; f32 inputs are cast to
    bf16 by the wrapper as by the plain version."""
    g = torch.Generator().manual_seed(7 * nin + shape[2])
    xs = [torch.randn(shape + (128,), generator=g).to(dev, dtype)
          for _ in range(nin)]
    ws = [(0.05 * torch.randn((3, 3, 128, 128), generator=g)).to(dev, dtype)
          for _ in range(nin)]
    raw = TB.conv3x3_bd_raw if nin == 1 else TB.conv3x3_bd2in_raw
    plain = TB.conv3x3_bd_plain if nin == 1 else TB.conv3x3_bd2in_plain
    n = raw.launches
    y32, s1, s2 = raw(*xs, *ws, stats=True, out_dtype=torch.float32)
    y16 = raw(*xs, *ws, out_dtype=torch.bfloat16)
    yd = raw(*xs, *ws)
    torch.cuda.synchronize()
    assert raw.launches == n + 3
    ry, rs1, rs2 = plain(*xs, *ws, stats=True, out_dtype=torch.float32)
    assert y16.dtype == torch.bfloat16 and yd.dtype == dtype
    assert s1.shape == s2.shape == (shape[0], 128)
    assert _rel(y32, ry) <= 1e-4
    assert _rel(y16, ry) <= 1e-2
    assert _rel(yd, ry) <= (1e-4 if dtype == torch.float32 else 1e-2)
    _assert_sums_close(s1, rs1)
    _assert_sums_close(s2, rs2)
