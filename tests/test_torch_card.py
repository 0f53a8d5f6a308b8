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


@pytest.mark.parametrize("shape", [(2, 13, 50), (7, 37, 66)])
@pytest.mark.parametrize("nin", [1, 2])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_relu", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_bf16_conv_strips_and_ranges(dev, shape, nin, out_dtype, bias_relu,
                                     stats):
    """The bf16 kernel past one 64-pixel strip and into ragged tails:
    widths of 100 and 132 pixels, heights not a multiple of anything, and
    CTA row ranges that cross sample boundaries. bf16 out within one bf16
    rounding of the plain f32 value, f32 out within 1e-3 (reassociation)."""
    xs, ws, bias = _inputs(dev, torch.bfloat16, *shape, seed=8 + nin)
    raw = TC.conv3x3_wp_raw if nin == 1 else TC.conv3x3_wp2_raw
    plain = TC.conv3x3_wp_plain if nin == 1 else TC.conv3x3_wp2_plain
    args = [*xs[:nin], *(m for wc in ws[:nin] for m in wc)]
    kw = dict(bias=bias, bias_relu=bias_relu, stats=stats)
    n = raw.launches
    got = raw(*args, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert raw.launches == n + 1
    ref = plain(*args, out_dtype=torch.float32, **kw)
    if not stats:
        got, ref = (got,), (ref,)
    assert got[0].dtype == out_dtype and got[0].shape == ref[0].shape
    if out_dtype == torch.float32:
        torch.testing.assert_close(got[0], ref[0], rtol=1e-3, atol=1e-3)
    else:
        _assert_close(got[0], ref[0], torch.bfloat16)
    for s, r in zip(got[1:], ref[1:]):
        _assert_sums_close(s, r)


@pytest.mark.parametrize("nin", [1, 2])
def test_bf16_conv_stats_are_deterministic(dev, nin):
    """Two calls with stats give the same bits for y, s1 and s2: partials
    per CTA and sample, summed in CTA order, no atomics."""
    xs, ws, bias = _inputs(dev, torch.bfloat16, 7, 37, 66, seed=10)
    raw = TC.conv3x3_wp_raw if nin == 1 else TC.conv3x3_wp2_raw
    args = [*xs[:nin], *(m for wc in ws[:nin] for m in wc)]
    first = raw(*args, stats=True)
    second = raw(*args, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


def _same(a, b):
    """Bit-level agreement as torch.equal sees it, NaN positions included:
    the same NaN mask, and equal values everywhere else."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0), b.masked_fill(nan, 0))


def _minmax_matches_plain(x):
    n = THD.minmax_complement.launches
    xn, xc = THD.minmax_complement(x)
    pair = THD.paired_input(x)
    torch.cuda.synchronize()
    assert THD.minmax_complement.launches == n + 2
    rn, rc = THD.minmax_complement_plain(x)
    assert xn.dtype == xc.dtype == x.dtype
    assert _same(xn, rn) and _same(xc, rc)
    assert _same(pair, torch.cat([rn, rc]))


# (3, 37, 53, 1) and (4, 29, 31, 3): m * sizeof(T) not a multiple of 16,
# so frame starts and paired_input's second half are misaligned;
# (8, 512, 512, 1): the train batch's frames; (1, 1024, 1500, 1) and
# (1, 2048, 1600, 1): frames too large to stay in shared memory (f32;
# bf16 only the second)
@pytest.mark.parametrize("shape", [(3, 37, 53, 1), (2, 64, 70, 3),
                                   (1, 512, 512, 1), (4, 29, 31, 3),
                                   (8, 512, 512, 1), (1, 1024, 1500, 1),
                                   (1, 2048, 1600, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minmax_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator().manual_seed(shape[1])
    _minmax_matches_plain((5 * torch.rand(shape, generator=g) - 1)
                          .to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minmax_setup_forms(dev, dtype):
    """The set-up's K and form: small frames one CTA, no cluster; the train
    batch resident in clusters of 8, or of 16 where the card holds 8 of
    them with one CTA an SM (an H100 holds 7); frames too large for 16
    shares of 200 KB streaming."""
    def plan(shape):
        return THD.minmax_plan(torch.empty(shape, dtype=dtype, device=dev))

    p = plan((2, 37, 53, 1))
    assert (p.k, p.streaming) == (1, False)
    p = plan((8, 512, 512, 1))
    full = THD.minmax_plan(torch.empty((8, 512, 512, 1), dtype=dtype,
                                       device=dev), k=16)
    assert (p.k, p.streaming) == (16 if full.clusters >= 8 else 8, False)
    assert p.clusters >= 8
    p = plan((1, 1024, 1500, 1))
    assert (p.k, p.streaming) == (16, dtype == torch.float32)
    p = plan((1, 2048, 1600, 1))
    assert (p.k, p.streaming) == (16, True)


@pytest.mark.parametrize("case", ["nan", "posinf", "neginf", "constant"])
@pytest.mark.parametrize("shape", [(3, 37, 53, 1), (2, 512, 512, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minmax_kernel_nonfinite_matches_plain(dev, case, shape, dtype):
    """NaN, +-inf and constant frames as the plain version (and the JAX
    kernel, tests/test_torch_head.py) treat them: min and max propagate
    NaN and the clamp keeps it. The value sits in the last frame, past the
    first CTA's share of a large frame."""
    g = torch.Generator().manual_seed(11)
    x = 5 * torch.rand(shape, generator=g) - 1
    if case == "constant":
        x[-1] = 2.5
    else:
        x[-1, shape[1] - 3, shape[2] // 2, 0] = {
            "nan": float("nan"), "posinf": float("inf"),
            "neginf": float("-inf")}[case]
    _minmax_matches_plain(x.to(dev, dtype))


# W of 1, 127, 129, 260 and H of 1, 3, 130 against the 2-row x 128-pixel
# tile; (70, 3, 129) has 280 tiles, 4 to a sample, so on an H100 (132
# CTAs, 3 tiles each, the last past the end) CTA ranges cross samples
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 12, 20), (3, 9, 37),
                                   (3, 1, 127), (2, 3, 129), (2, 130, 1),
                                   (3, 130, 260), (70, 3, 129)])
@pytest.mark.parametrize("nin", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bd_kernel_matches_plain(dev, shape, nin, dtype):
    """Dense (not block-diagonal) weights; f32 inputs are cast to bf16 by
    the wrapper as by the plain version; both output dtypes; the stats
    bit-identical over two calls."""
    g = torch.Generator().manual_seed(7 * nin + shape[2])
    xs = [torch.randn(shape + (128,), generator=g).to(dev, dtype)
          for _ in range(nin)]
    ws = [(0.05 * torch.randn((3, 3, 128, 128), generator=g)).to(dev, dtype)
          for _ in range(nin)]
    raw = TB.conv3x3_bd_raw if nin == 1 else TB.conv3x3_bd2in_raw
    plain = TB.conv3x3_bd_plain if nin == 1 else TB.conv3x3_bd2in_plain
    n = raw.launches
    y32, s1, s2 = raw(*xs, *ws, stats=True, out_dtype=torch.float32)
    y16, t1, t2 = raw(*xs, *ws, stats=True, out_dtype=torch.bfloat16)
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
    assert torch.equal(s1, t1) and torch.equal(s2, t2)
