"""The differentiable pair-packed conv (onet_tpu_torch/ops/conv_wp.py:
conv3x3_wp, conv3x3_wp2, conv3x3_wp_dw) against the JAX package's custom
VJPs, with its Pallas kernels in interpret mode on the CPU.

On CPU tensors the port runs its plain versions, so this holds the plain
arithmetic, the stats epilogue's contract and the VJP wiring (dx through
the forward conv with flip_transpose'd weights, dw through conv3x3_wp_dw,
no gradient through s1/s2) to the TPU kernels'. N=2, H=8, W=16 (Wp=8),
fp32; inputs and cotangents from a numpy seed. Tolerance: float32
reassociation of sums — 1e-5 (relative and absolute) on y and dx (576-term
sums), and 1e-5 of the largest magnitude on s1, s2 and dw (sums over all
pixels of the batch).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import onet_tpu.ops.pallas_conv as PC
from onet_tpu_torch.ops import conv_wp as TC

N, H, WP = 2, 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(PC, "INTERPRET", True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return {"xa": f(N, H, WP, 128), "xb": f(N, H, WP, 128),
            "dy": f(N, H, WP, 128),
            "wa": 0.1 * f(3, 3, 64, 64), "wb": 0.1 * f(3, 3, 64, 64)}


def _close_sum(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_flip_transpose_matches_jax(data):
    np.testing.assert_array_equal(
        TC.flip_transpose(torch.tensor(data["wa"])).numpy(),
        np.asarray(PC.flip_transpose(jnp.asarray(data["wa"]))))


@pytest.mark.parametrize("shape", [(2, 8, 8), (1, 6, 4), (3, 16, 2)])
def test_dw_plain_matches_jax(data, shape):
    """The plain dw (the JAX kernel's quadrant products and assembly)."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((*shape, 128)).astype(np.float32)
    dy = rng.standard_normal((*shape, 128)).astype(np.float32)
    before = TC.conv3x3_wp_dw.launches
    dw = TC.conv3x3_wp_dw(torch.tensor(x), torch.tensor(dy))
    assert TC.conv3x3_wp_dw.launches == before       # CPU: no kernel launch
    assert dw.shape == (3, 3, 64, 64) and dw.dtype == torch.float32
    _close_sum(dw.numpy(), PC.conv3x3_wp_dw(jnp.asarray(x), jnp.asarray(dy),
                                            interpret=True))


def test_dw_is_the_weight_gradient_of_the_unpacked_conv(data):
    """dw against autograd of F.conv2d on the unpacked NHWC tensors: the
    packing is a relayout, not another function."""
    x, dy = torch.tensor(data["xa"]), torch.tensor(data["dy"])
    w = torch.zeros((3, 3, 64, 64), requires_grad=True)
    xu = x.reshape(N, H, 2 * WP, 64).permute(0, 3, 1, 2)
    y = torch.nn.functional.conv2d(xu, w.permute(3, 2, 0, 1), padding=1)
    y.backward(dy.reshape(N, H, 2 * WP, 64).permute(0, 3, 1, 2))
    _close_sum(TC.conv3x3_wp_dw(x, dy).numpy(), w.grad.numpy())


def test_conv3x3_wp_and_its_vjp_match_jax(data):
    def jf(x, w):
        return PC.conv3x3_wp(x, w)

    (jy, js1, js2), vjp = jax.vjp(jf, jnp.asarray(data["xa"]),
                                  jnp.asarray(data["wa"]))
    jdx, jdw = vjp((jnp.asarray(data["dy"]), jnp.zeros_like(js1),
                    jnp.zeros_like(js2)))
    x = torch.tensor(data["xa"], requires_grad=True)
    w = torch.tensor(data["wa"], requires_grad=True)
    y, s1, s2 = TC.conv3x3_wp(x, w)
    assert not s1.requires_grad and not s2.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    _close_sum(s1.numpy(), js1)
    _close_sum(s2.numpy(), js2)
    y.backward(torch.tensor(data["dy"]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **TOL)
    _close_sum(w.grad.numpy(), jdw)


def test_conv3x3_wp2_and_its_vjp_match_jax(data):
    args = [jnp.asarray(data[k]) for k in ("xa", "xb", "wa", "wb")]
    (jy, js1, js2), vjp = jax.vjp(PC.conv3x3_wp2, *args)
    jgrads = vjp((jnp.asarray(data["dy"]), jnp.zeros_like(js1),
                  jnp.zeros_like(js2)))
    targs = [torch.tensor(data[k], requires_grad=True)
             for k in ("xa", "xb", "wa", "wb")]
    y, s1, s2 = TC.conv3x3_wp2(*targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    _close_sum(s1.numpy(), js1)
    _close_sum(s2.numpy(), js2)
    y.backward(torch.tensor(data["dy"]))
    for t, jg in zip(targs[:2], jgrads[:2]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)
    for t, jg in zip(targs[2:], jgrads[2:]):
        _close_sum(t.grad.numpy(), jg)


def test_vjp_takes_a_non_contiguous_f32_cotangent_for_bf16(data):
    """dy arrives as autograd hands it: here f32 and transposed, for a bf16
    conv. The backward casts it to x's dtype first, as the JAX VJP does,
    and the gradients come back in the inputs' dtypes."""
    x = torch.tensor(data["xa"]).to(torch.bfloat16).requires_grad_(True)
    w = torch.tensor(data["wa"]).to(torch.bfloat16).requires_grad_(True)
    y, _, _ = TC.conv3x3_wp(x, w)
    dy = torch.tensor(data["dy"]).transpose(1, 2).contiguous().transpose(1, 2)
    assert not dy.is_contiguous()
    (y.float() * dy).sum().backward()
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    dyb = dy.to(torch.bfloat16).contiguous()
    ref = TC.conv3x3_wp_dw(x.detach(), dyb).to(torch.bfloat16)
    np.testing.assert_array_equal(w.grad.float().numpy(), ref.float().numpy())


def test_dw_rejects_mismatched_inputs(data):
    x = torch.tensor(data["xa"])
    with pytest.raises(ValueError):
        TC.conv3x3_wp_dw(x, x[:, :4])
    with pytest.raises(ValueError):
        TC.conv3x3_wp_dw(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        TC.conv3x3_wp_dw(x[..., :64], x[..., :64])
