"""The port's pair-packed conv (onet_tpu_torch/ops/conv_wp.py) against the
JAX package's Pallas kernels run in interpret mode on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions, so
this holds the plain arithmetic (and the layout helpers around the CUDA
kernel) to the TPU kernel's contract. Inputs come from a numpy seed.
Tolerance 1e-5 (relative and absolute) is float32 reassociation of the tap
sum: both sides accumulate the same exact products in another order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import onet_tpu.ops.pallas_conv as PC
from onet_tpu_torch.ops import conv_wp as TC

N, H, WP = 2, 16, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return {
        "xa": rng.standard_normal((N, H, WP, 128)).astype(np.float32),
        "xb": rng.standard_normal((N, H, WP, 128)).astype(np.float32),
        "wa": (0.1 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32),
        "wb": (0.1 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32),
        "bias": rng.standard_normal(128).astype(np.float32),
        "stacked": rng.standard_normal((N, H, 2 * WP, 128)).astype(
            np.float32),
    }


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _jx(a, dtype):
    return jnp.asarray(a).astype(_jdt(dtype))


def _tx(a, dtype):
    return torch.tensor(a).to(dtype)


def test_layout_helpers_match_jax(data):
    s = data["stacked"]
    packed = TC.pack_wp(torch.tensor(s))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(PC.pack_wp(jnp.asarray(s))))
    np.testing.assert_array_equal(TC.unpack_wp(packed).numpy(), s)
    for dtype in (torch.float32, torch.bfloat16):
        wc, we = TC.make_wc_we(torch.tensor(data["wa"]), dtype=dtype)
        jwc, jwe = PC.make_wc_we(jnp.asarray(data["wa"]), dtype=_jdt(dtype))
        np.testing.assert_array_equal(wc.float().numpy(),
                                      np.asarray(jwc, np.float32))
        np.testing.assert_array_equal(we.float().numpy(),
                                      np.asarray(jwe, np.float32))
        # the CUDA kernel's taps, read back from Wc, are the weight itself
        np.testing.assert_array_equal(
            TC.taps_from_wc(wc).float().numpy(),
            np.asarray(jnp.asarray(data["wa"]).astype(_jdt(dtype)),
                       np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_relu", [False, True])
def test_conv3x3_wp_raw_matches_jax(data, bias_relu, dtype):
    """f32 accumulators (out_dtype f32) on f32 and bf16 inputs, with the
    per-sample lane stats of the plain version."""
    wc, we = TC.make_wc_we(torch.tensor(data["wa"]), dtype=dtype)
    jwc, jwe = PC.make_wc_we(jnp.asarray(data["wa"]), dtype=_jdt(dtype))
    before = TC.conv3x3_wp_raw.launches
    y, s1, s2 = TC.conv3x3_wp_raw(
        _tx(data["xa"], dtype), wc, we, bias=torch.tensor(data["bias"]),
        bias_relu=bias_relu, stats=True, out_dtype=torch.float32)
    jy, js1, js2 = PC.conv3x3_wp_raw(
        _jx(data["xa"], dtype), jwc, jwe, bias=jnp.asarray(data["bias"]),
        bias_relu=bias_relu, stats=True, out_dtype=jnp.float32,
        interpret=True)
    assert TC.conv3x3_wp_raw.launches == before     # CPU: no kernel launch
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("bias_relu", [False, True])
def test_conv3x3_wp2_raw_matches_jax(data, bias_relu):
    ws = [TC.make_wc_we(torch.tensor(data[k]), dtype=torch.float32)
          for k in ("wa", "wb")]
    jws = [PC.make_wc_we(jnp.asarray(data[k]), dtype=jnp.float32)
           for k in ("wa", "wb")]
    before = TC.conv3x3_wp2_raw.launches
    y, s1, s2 = TC.conv3x3_wp2_raw(
        torch.tensor(data["xa"]), torch.tensor(data["xb"]), *ws[0], *ws[1],
        bias=torch.tensor(data["bias"]), bias_relu=bias_relu, stats=True)
    jy, js1, js2 = PC.conv3x3_wp2_raw(
        jnp.asarray(data["xa"]), jnp.asarray(data["xb"]), *jws[0], *jws[1],
        bias=jnp.asarray(data["bias"]), bias_relu=bias_relu, stats=True,
        interpret=True)
    assert TC.conv3x3_wp2_raw.launches == before
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5,
                               atol=1e-3)


def test_bf16_output_rounds_the_f32_accumulator(data):
    """Default out_dtype is the input's: bf16 in, bf16 out, equal to the
    f32 result rounded once."""
    wc, we = TC.make_wc_we(torch.tensor(data["wa"]), dtype=torch.bfloat16)
    x = _tx(data["xa"], torch.bfloat16)
    y16 = TC.conv3x3_wp_raw(x, wc, we, bias=torch.tensor(data["bias"]),
                            bias_relu=True)
    y32 = TC.conv3x3_wp_raw(x, wc, we, bias=torch.tensor(data["bias"]),
                            bias_relu=True, out_dtype=torch.float32)
    assert y16.dtype == torch.bfloat16
    np.testing.assert_array_equal(y16.float().numpy(),
                                  y32.to(torch.bfloat16).float().numpy())


def test_wrapper_rejects_bad_shapes(data):
    wc, we = TC.make_wc_we(torch.tensor(data["wa"]), dtype=torch.float32)
    with pytest.raises(ValueError):
        TC.conv3x3_wp_raw(torch.zeros(2, 4, 4, 64), wc, we)
    with pytest.raises(ValueError):
        TC.conv3x3_wp_raw(torch.zeros(2, 4, 4, 128), wc[:, :64], we)
    with pytest.raises(ValueError):
        TC.make_wc_we(torch.zeros(3, 3, 32, 64))
