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


@pytest.mark.parametrize("nin", [1, 2])
def test_conv_at_the_nau_shape_matches_plain(dev, nin):
    """The eval forward's stats-epilogue convs at the NAU transfer's shape:
    batch 5 of 200x200 frames, N=10 packed samples of width 100."""
    xs, ws, bias = _inputs(dev, torch.bfloat16, 10, 200, 100, seed=20 + nin)
    raw = TC.conv3x3_wp_raw if nin == 1 else TC.conv3x3_wp2_raw
    plain = TC.conv3x3_wp_plain if nin == 1 else TC.conv3x3_wp2_plain
    args = [*xs[:nin], *(m for wc in ws[:nin] for m in wc)]
    n = raw.stats_launches
    y, s1, s2 = raw(*args, stats=True)
    torch.cuda.synchronize()
    assert raw.stats_launches == n + 1
    ry, rs1, rs2 = plain(*args, stats=True, out_dtype=torch.float32)
    _assert_close(y, ry, torch.bfloat16)
    _assert_sums_close(s1, rs1)
    _assert_sums_close(s2, rs2)


def _bits(t):
    return t.view(torch.int32).long()


def test_roc_points_on_the_card_matches_cpu(dev):
    """Thresholds within 2 float32 ulps (float64 log and pow may round
    apart), far and dr equal wherever no score lies within 2 ulps of a
    threshold."""
    from onet_tpu_torch.metrics.roc import roc_points

    g = torch.Generator().manual_seed(30)
    labels = torch.rand((8, 224, 224), generator=g) < 0.02
    score = torch.randn((8, 224, 224), generator=g) + 2.0 * labels
    got = [t.cpu() for t in roc_points(score.to(dev), labels.to(dev), 512)]
    ref = roc_points(score, labels, 512)
    assert (_bits(got[2]) - _bits(ref[2])).abs().max() <= 2
    srt = torch.sort(score.reshape(-1)).values
    i = torch.searchsorted(srt, ref[2]).clamp(1, srt.numel() - 1)
    near = torch.minimum((_bits(srt[i]) - _bits(ref[2])).abs(),
                         (_bits(srt[i - 1]) - _bits(ref[2])).abs()) <= 2
    for g_, r_ in zip(got[:2], ref[:2]):
        assert torch.equal(g_[~near], r_[~near])


def test_cfar_seg_batch_on_the_card_matches_cpu(dev):
    """Masks equal except at pixels within 1e-5 * kval * bg of the
    decision, where the two cumsums' orders may differ."""
    from onet_tpu_torch.metrics import cfar as CF

    g = torch.Generator().manual_seed(31)
    u = torch.rand((4, 200, 200), generator=g).clamp_min(1e-30)
    imgs = torch.sqrt(-2.0 * torch.log(u))                  # Rayleigh
    imgs[:, 50:60, 80:90] += 6.0
    got = CF.cfar_seg_batch(imgs.to(dev), 2.0).cpu()
    ref = CF.cfar_seg_batch(imgs, 2.0)
    x = imgs.double()
    ii = CF._integral(x)
    (rs, rc), (gs, gc) = (CF._window_sums(ii, 200, 200, r) for r in (16, 8))
    bg = (rs - gs) / torch.clamp_min(rc - gc, 1)
    near = (x - 2.0 * bg).abs() <= 1e-5 * 2.0 * bg
    assert not bool(((got != ref) & ~near).any())
    assert got.dtype == torch.int32 and 0.005 < got.float().mean() < 0.2


def test_zy3_step_launches_match_plain(dev, monkeypatch):
    """Every kernel launch of one pair-packed ZY-3 train step (base 64,
    batch 5 of 224x224 RGB, bf16: N=10 packed samples, the 6-channel
    stacked input through inc.conv1 first) against its plain version on
    the operands the step gave it: 3 stats-epilogue forwards (one of them
    two-input), 4 dx convs, 4 weight gradients."""
    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models import onet as TO
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step

    ops = []
    real_launch, real_dw = TC._launch, TC._launch_dw

    def launch(xs, taps, *rest):
        ops.append(("conv", [x.clone() for x in xs],
                    [t.clone() for t in taps], *rest))
        return real_launch(xs, taps, *rest)

    def launch_dw(x, dy):
        ops.append(("dw", x.clone(), dy.clone()))
        return real_dw(x, dy)

    monkeypatch.setattr(TC, "_launch", launch)
    monkeypatch.setattr(TC, "_launch_dw", launch_dw)
    monkeypatch.setattr(TO, "PAIR_PACK", True)
    params, state = TO.onet_init(torch.Generator().manual_seed(40), 3,
                                 device=dev)
    x = torch.rand((5, 224, 224, 3), generator=torch.Generator()
                   .manual_seed(41)).to(dev)
    step = make_train_step(policy=BF16_COMPUTE)
    loss = step(params, state, adam_init(params), x, 1e-4)[3]
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    seen = {}
    for op in ops:
        if op[0] == "dw":
            _, xx, dy = op
            key = "dw"
            _assert_sums_close(real_dw(xx, dy),
                               TC.conv3x3_wp_dw_plain(xx, dy))
        else:
            _, xs, taps, bias, bias_relu, stats, out_dtype = op
            key = ("stats" if stats else "dx") + str(len(xs))
            ws = [m for t in taps for m in TC.make_wc_we(t, dtype=t.dtype)]
            plain = (TC.conv3x3_wp_plain if len(xs) == 1
                     else TC.conv3x3_wp2_plain)
            ref = plain(*xs, *ws, bias=bias, bias_relu=bias_relu,
                        stats=stats, out_dtype=torch.float32)
            got = real_launch(xs, taps, bias, bias_relu, stats, out_dtype)
            if stats:
                _assert_close(got[0], ref[0], xs[0].dtype)
                _assert_sums_close(got[1], ref[1])
                _assert_sums_close(got[2], ref[2])
            else:
                _assert_close(got, ref, xs[0].dtype)
        assert op[1][0].shape[0] == 10 if op[0] == "conv" else \
            op[1].shape[0] == 10
        seen[key] = seen.get(key, 0) + 1
    assert seen == {"stats1": 2, "stats2": 1, "dx1": 4, "dw": 4}


def test_zy3_preprocessing_on_the_card_matches_cpu(dev):
    """dehaze and the nine preprocessing options on uint8 thumbnails: the
    card computes what the CPU computes (every step elementwise, exact or
    a true division)."""
    from onet_tpu_torch.preprocess.haze import dehaze
    from onet_tpu_torch.preprocess.image import PRE_OPTIONS, apply_pre_option

    u8 = torch.randint(0, 256, (3, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(42))
    im = u8.float() / 255.0
    for got, ref in zip(dehaze(im.to(dev)), dehaze(im)):
        assert torch.equal(got.cpu(), ref)
    for option in PRE_OPTIONS:
        assert torch.equal(apply_pre_option(u8.to(dev), option).cpu(),
                           apply_pre_option(u8, option)), option


def _serving_model(dev, base, seed):
    """A seeded weight-shared Onet with perturbed BN statistics, folded."""
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.models.onet import onet_init

    gen = torch.Generator().manual_seed(seed)
    params, state = onet_init(gen, 1, base=base, device=dev)

    def perturb(tree):
        if "var" in tree:
            c = tree["var"].shape
            return {"mean": (0.1 * torch.randn(c, generator=gen)).to(dev),
                    "var": (0.5 + torch.rand(c, generator=gen)).to(dev)}
        return {k: perturb(v) for k, v in tree.items()}

    state = perturb(state)
    return params, state, fold_onet(params, state)


def test_tiled_scene_matches_host_tiling(dev):
    """infer_tiled on the card (windows sliced there, mask assembled there,
    one read) equals the JAX package's algorithm run from the host (windows
    stacked with numpy, each batch read back) on the same pair-packed bf16
    step, and launches the pair-packed convs 2 + 1 times a window batch."""
    import numpy as np

    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import onet_infer
    from onet_tpu_torch.serve.tiles import _plan, infer_tiled

    _, _, folded = _serving_model(dev, 64, 50)

    def step(f, xb):
        return onet_infer(f, xb, policy=BF16_COMPUTE, pair_pack=True)

    tile, halo, batch = 256, 32, 4
    win = tile + 2 * halo
    scene = torch.rand((600, 700, 1), generator=torch.Generator()
                       .manual_seed(51)).numpy()
    n1, n2 = TC.conv3x3_wp_raw.launches, TC.conv3x3_wp2_raw.launches
    got = infer_tiled(step, folded, scene, tile=tile, halo=halo,
                      batch=batch, device=dev)
    torch.cuda.synchronize()
    h, w, _ = scene.shape
    coords = [(y, x, min(max(y - halo, 0), h - win),
               min(max(x - halo, 0), w - win))
              for y in _plan(h, tile) for x in _plan(w, tile)]
    batches = -(-len(coords) // batch)
    assert TC.conv3x3_wp_raw.launches - n1 == 2 * batches
    assert TC.conv3x3_wp2_raw.launches - n2 == batches
    want = np.zeros((h, w), np.int32)
    with torch.inference_mode():
        for i in range(0, len(coords), batch):
            part = coords[i:i + batch]
            wins = np.stack([scene[wy:wy + win, wx:wx + win]
                             for _, _, wy, wx in part])
            wins = np.concatenate([wins] + [wins[-1:]] * (batch - len(part)))
            labels = step(folded, torch.from_numpy(wins).to(dev))[1].cpu()
            for j, (y, x, wy, wx) in enumerate(part):
                ey, ex = min(tile, h - y), min(tile, w - x)
                want[y:y + ey, x:x + ex] = labels[
                    j, y - wy:y - wy + ey, x - wx:x - wx + ex].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_session_masks_through_pinned_staging(dev, mode):
    """The serving session at the serve cells' shape (base 64, 512^2,
    batch 32, 40 frames: a whole batch and a padded one): its masks equal
    the step's labels read to the host and cast there, as the session
    read them before it narrowed them on the card; its staging buffer is
    pinned, made once, and every batch's labels come through it."""
    import numpy as np

    from onet_tpu_torch.core.policy import BF16_COMPUTE
    from onet_tpu_torch.models.infer import onet_infer
    from onet_tpu_torch.serve.http import ServingSession
    from onet_tpu_torch.utils import profiling as P

    _, _, folded = _serving_model(dev, 64, 70)
    frames = np.random.default_rng(71).uniform(
        0, 1, (40, 512, 512, 1)).astype(np.float32)
    if mode == "int8":
        from onet_tpu_torch.models import quant as TQ
        with torch.inference_mode():
            model_arg = TQ.quantize_folded(folded, TQ.calibrate(
                folded, torch.from_numpy(frames[:32]).to(dev)))
        step = TQ.onet_infer_q
    else:
        model_arg = folded

        def step(f, xb):
            return onet_infer(f, xb, policy=BF16_COMPUTE)
    sess = ServingSession(step, model_arg, batch=32, in_channels=1,
                          mode=mode, device=dev)
    before = P.counters()
    masks, _ = sess.segment(frames)
    after = P.counters()
    padded = np.concatenate([frames, np.repeat(frames[-1:], 24, axis=0)])
    with torch.inference_mode():
        want = np.concatenate([
            step(model_arg, torch.from_numpy(padded[i:i + 32]).to(dev))[1]
            .cpu().numpy().astype(np.uint8) for i in (0, 32)])[:40]
    assert masks.shape == (40, 512, 512) and masks.dtype == np.uint8
    assert np.array_equal(masks, want)
    assert sess._staging.is_pinned()
    assert sess._staging.numel() == 32 * 512 * 512
    assert after["labels_staged"] - before.get("labels_staged", 0) == 2
    assert after["staging_allocs"] - before.get("staging_allocs", 0) == 1


@pytest.mark.parametrize("export_on", ["cuda", "cpu"])
def test_artifact_on_the_card_matches_live_stacked(dev, tmp_path, export_on):
    """An fp32 artifact (base 8, 64x64, symbolic batch), exported on the
    card or on the CPU and loaded on the card, against the live stacked
    step on the card: S within 1e-5 (TF32 off on both), labels agreeing
    on >= 99.9% of the pixels."""
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.models.infer import onet_infer
    from onet_tpu_torch.models.unet import tree_map
    from onet_tpu_torch.serve.artifact import (export_serving_artifact,
                                               load_serving_artifact)

    params, state, folded = _serving_model(dev, 8, 52)
    if export_on == "cpu":
        params, state = (tree_map(lambda t: t.cpu(), t)
                         for t in (params, state))
    path = str(tmp_path / "m.onetp")
    meta = export_serving_artifact(params, state, path, input_hw=(64, 64),
                                   policy=DEFAULT, device=export_on)
    assert meta["device"] == export_on
    call, _ = load_serving_artifact(path, device=dev)
    x = torch.rand((3, 64, 64, 1), generator=torch.Generator()
                   .manual_seed(53)).to(dev)
    s, labels = call(x)
    assert s.device.type == "cuda" and labels.dtype == torch.int32
    with torch.inference_mode():
        s_live, l_live = onet_infer(folded, x, policy=DEFAULT,
                                    pair_pack=False)
    torch.testing.assert_close(s, s_live, atol=1e-5, rtol=0)
    assert (labels == l_live).float().mean().item() >= 0.999


# ---------------------------------------------------------------------------
# int8 convolutions (csrc/conv_i8.cu)
# ---------------------------------------------------------------------------

I8_SHAPES = [
    # (convT, n, h, w, ci, co): odd H/W, K tails (ci 2 and 6 padded to 4
    # and 8 -> K 36 / 72 of a 64-byte step; ci 48 -> K 432), a column tile
    # cut short (co 200), M not a multiple of 128
    (False, 2, 17, 23, 2, 128),
    (False, 1, 31, 9, 6, 64),
    (False, 3, 13, 11, 48, 200),
    (False, 1, 8, 8, 256, 128),
    (True, 2, 7, 9, 64, 32),
    (True, 1, 5, 13, 48, 100),
]


def _i8_operands(dev, convt, n, h, w, ci, co, seed=0):
    g = torch.Generator().manual_seed(seed)
    kh = 2 if convt else 3
    x = torch.randint(-127, 128, (n, h, w, ci), generator=g,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (kh, kh, ci, co), generator=g,
                       dtype=torch.int8)
    scale = (torch.rand(co, generator=g) + 0.5) * 1e-4
    bias = torch.randn(co, generator=g)
    s_next = torch.rand(co, generator=g) * 0.02 + 0.005
    return [t.to(dev) for t in (x, wq, scale, bias, s_next)]


@pytest.mark.parametrize("requant", [None, "unsigned", "signed"])
@pytest.mark.parametrize("shape", I8_SHAPES)
def test_conv_i8_kernels_match_plain(dev, shape, requant):
    """The int32 accumulator, the f32 epilogue and the int8 codes of the
    kernel equal the plain version's (float64 on the codes) bit for bit."""
    from onet_tpu_torch.ops import conv_i8 as CI

    convt = shape[0]
    x, wq, scale, bias, s_next = _i8_operands(dev, *shape)
    fn = CI.convT2x2_i8 if convt else CI.conv3x3_i8
    plain = CI.convT2x2_i8_plain if convt else CI.conv3x3_i8_plain
    before = fn.launches
    acc = fn(x, wq)
    y = fn(x, wq, scale, bias, requant=requant,
           s_next=None if requant is None else s_next)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(acc, plain(x, wq))
    want = plain(x, wq, scale, bias, requant=requant,
                 s_next=None if requant is None else s_next)
    assert y.dtype == want.dtype and torch.equal(y, want)


def test_conv_i8_dx_form_matches_plain(dev):
    """int8 training's dx conv: signed codes, the flip-transposed weight
    view (not contiguous), a per-tensor scale as a vector, no bias."""
    from onet_tpu_torch.ops import conv_i8 as CI

    x, wq, _, _, _ = _i8_operands(dev, False, 2, 16, 16, 64, 32, seed=3)
    wt = wq.flip(0, 1).permute(0, 1, 3, 2)[..., :64]
    dy = torch.randint(-127, 128, (2, 16, 16, 32), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(4)).to(dev)
    s = torch.full((64,), 3e-5, device=dev)
    y = CI.conv3x3_i8(dy, wt, s)
    assert torch.equal(y, CI.conv3x3_i8_plain(dy, wt, s))


def test_int8_artifact_from_the_cpu_serves_on_the_card(dev, tmp_path):
    """An int8 artifact (base 8, 64x64) exported and calibrated on the CPU,
    loaded on the card: its calls launch the int8 kernels, and its masks
    equal the live int8 graph's on the card with the same parameters."""
    from onet_tpu_torch.models import quant as TQ
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.models.unet import tree_map
    from onet_tpu_torch.ops import conv_i8 as CI
    from onet_tpu_torch.serve.artifact import (export_serving_artifact,
                                               load_serving_artifact)

    params, state, _ = _serving_model(torch.device("cpu"), 8, 61)
    calib = torch.rand((4, 64, 64, 1),
                       generator=torch.Generator().manual_seed(62))
    path = str(tmp_path / "q.onetp")
    meta = export_serving_artifact(params, state, path, input_hw=(64, 64),
                                   int8_calib=calib, device="cpu")
    assert meta["arithmetic"] == "int8+bf16head" and meta["device"] == "cpu"
    call, _ = load_serving_artifact(path, device=dev)
    x = calib[:3].to(dev)
    before = (CI.conv3x3_i8.launches, CI.convT2x2_i8.launches)
    s, labels = call(x)
    torch.cuda.synchronize()
    assert (CI.conv3x3_i8.launches - before[0],
            CI.convT2x2_i8.launches - before[1]) == (16, 4)
    with torch.inference_mode():
        folded = fold_onet(params, state)
        q = TQ.quantize_folded(folded, TQ.calibrate(folded, calib))
        q = tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t, q)
        s_live, l_live = TQ.onet_infer_q(q, x)
    assert s.device.type == "cuda" and labels.dtype == torch.int32
    assert torch.equal(labels, l_live.to(torch.int32))
    torch.testing.assert_close(s, s_live, rtol=0, atol=0)


# the TMA tiling's edges: (convT, n, h, w, ci, co). W not a multiple of the
# box width (200, 40, 70, 130, 33, 300), boxes past an image's last row
# (bh 2 at h 9, bh 32 at h 7), ci 2 / 6 / 16 (padded to 32), 64, 128,
# 256, 1024, co under 8 and not a multiple of 8 (5, 7, 3, 12, 20, 130,
# 72, 136), M under one tile (16, 21, 10 pixels)
I8_EDGE_SHAPES = [
    (False, 2, 9, 64, 256, 72),
    (False, 1, 3, 300, 128, 136),
    (False, 1, 5, 200, 16, 24),
    (False, 2, 9, 40, 64, 130),
    (False, 1, 7, 3, 1024, 5),
    (False, 2, 33, 17, 6, 12),
    (False, 1, 4, 4, 2, 7),
    (False, 1, 12, 70, 128, 64),
    (False, 4, 32, 32, 128, 128),
    (True, 1, 3, 130, 16, 3),
    (True, 2, 9, 33, 128, 20),
    (True, 1, 2, 5, 1024, 64),
    (True, 1, 6, 64, 64, 8),
]
I8_MODES = ["acc", None, "unsigned", "signed", "pair"]


def _i8_call(fn, x, wq, scale, bias, s_next, mode):
    """One call in out mode ``mode`` ("acc": the int32 accumulator;
    "pair": the two unsigned code tensors at s_next and s_next / 2)."""
    if mode == "acc":
        return fn(x, wq)
    if mode == "pair":
        return fn(x, wq, scale, bias, requant=("unsigned", "unsigned"),
                  s_next=(s_next, s_next / 2))
    return fn(x, wq, scale, bias, requant=mode,
              s_next=None if mode is None else s_next)


def _i8_equal(y, want):
    if isinstance(want, tuple):
        assert isinstance(y, tuple) and len(y) == len(want)
        for a, b in zip(y, want):
            _i8_equal(a, b)
        return
    assert y.dtype == want.dtype and y.shape == want.shape
    assert torch.equal(y, want), int((y != want).sum())


@pytest.mark.parametrize("mode", I8_MODES)
@pytest.mark.parametrize("shape", I8_SHAPES + I8_EDGE_SHAPES)
def test_conv_i8_every_mode_at_the_tiling_edges(dev, shape, mode):
    """Every out mode, U8X2 too, of both kernels bit-equal to the plain
    version (float64 on the codes) at the tiling's edge shapes; one launch
    a call."""
    from onet_tpu_torch.ops import conv_i8 as CI

    convt = shape[0]
    x, wq, scale, bias, s_next = _i8_operands(dev, *shape, seed=11)
    fn = CI.convT2x2_i8 if convt else CI.conv3x3_i8
    plain = CI.convT2x2_i8_plain if convt else CI.conv3x3_i8_plain
    before = fn.launches
    y = _i8_call(fn, x, wq, scale, bias, s_next, mode)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _i8_equal(y, _i8_call(plain, x, wq, scale, bias, s_next, mode))


@pytest.mark.parametrize("ck", [32, 64, 128])
@pytest.mark.parametrize("convt", [False, True])
def test_conv_i8_every_k_step_matches_plain(dev, convt, ck):
    """Each K step and swizzle (32, 64, 128 bytes) the kernel has, forced
    at ci 256, bit-equal to the plain version."""
    from onet_tpu_torch.ops import conv_i8 as CI

    x, wq, scale, bias, s_next = _i8_operands(dev, convt, 2, 9, 40, 256, 72,
                                              seed=12)
    xk, b, p = CI.operands(x, wq, convt, ck=ck)
    assert p.ck == ck
    y = CI.kernel(xk, b, p, 72, scale, bias, (s_next, s_next / 3),
                  CI.OUT_U8X2, convt)
    acc = CI.kernel(xk, b, p, 72, None, None, None, CI.OUT_I32, convt)
    torch.cuda.synchronize()
    assert torch.equal(acc, CI.plain(x, wq, None, None, None, CI.OUT_I32,
                                     convt))
    _i8_equal(y, CI.plain(x, wq, scale, bias, (s_next, s_next / 3),
                          CI.OUT_U8X2, convt))


def test_conv_i8_two_ctas_an_sm(dev):
    """The design's occupancy: two CTAs an SM for every instantiation (one
    CTA's epilogue overlaps the other's products)."""
    from onet_tpu_torch.ops import conv_i8 as CI

    for convt in (False, True):
        for ck in (32, 64, 128):
            assert CI.occupancy(ck, convt) == 2, (ck, convt)


def test_adam_update_waits_for_nothing_and_keeps_its_arithmetic(dev):
    """Adam on the card makes no synchronizing call (the host launches it
    while the backward pass runs), and its updates and state equal, bit
    for bit, each leaf's ops taken one after the other."""
    from onet_tpu_torch.models.unet import tree_leaves, tree_map
    from onet_tpu_torch.train.optim import B1, B2, EPS, adam_init, adam_update

    g = torch.Generator().manual_seed(23)
    params = {"a": {"w": torch.randn(96, 288, generator=g),
                    "b": torch.randn(288, generator=g)},
              "l": [torch.randn(169, 3, generator=g), torch.randn(7, generator=g)]}
    params = tree_map(lambda t: t.to(dev), params)
    opt = adam_init(params)
    mu, nu = tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params)
    for t in range(1, 4):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=g).to(dev)
                         * 10.0 ** t, params)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            upd, opt = adam_update(grads, opt, 5e-6)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for gl, m, v, u in zip(tree_leaves(grads), tree_leaves(mu),
                               tree_leaves(nu), tree_leaves(upd)):
            m.mul_(B1).add_((1 - B1) * gl)
            v.mul_(B2).add_((1 - B2) * gl.square())
            c = torch.tensor(float(t), device=dev)
            bc1 = 1 - torch.tensor(B1, device=dev) ** c
            bc2 = 1 - torch.tensor(B2, device=dev) ** c
            assert torch.equal(u, -5e-6 * ((m / bc1)
                                           / (torch.sqrt(v / bc2) + EPS)))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(opt["mu"]) + tree_leaves(opt["nu"]),
                       tree_leaves(mu) + tree_leaves(nu)))
        assert int(opt["count"]) == t
