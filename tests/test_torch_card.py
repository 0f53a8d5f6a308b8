"""The hand-written CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card and nvcc; skips without them. This file imports no
JAX, so on the machine with the card it runs without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Shapes include ragged tiles (H not a multiple of 8, W not of 32) to cover
the kernel's edge masking. Tolerances: f32 (TF32 off) 1e-4, the
reassociation of a 576-term sum; bf16 against the plain version's f32
accumulator on the same bf16 inputs, 2e-2 of max|y|, one bf16 rounding of
the output.
"""

import pytest
import torch

from onet_tpu_torch.ops import conv_wp as TC

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


def test_stats_raise_on_the_card(dev):
    xs, ws, _ = _inputs(dev, torch.bfloat16, 1, 8, 8)
    with pytest.raises(NotImplementedError, match="training slice"):
        TC.conv3x3_wp_raw(xs[0], *ws[0], stats=True)
