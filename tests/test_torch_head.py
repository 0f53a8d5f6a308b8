"""The port's JSD head and min-max ops (onet_tpu_torch/ops/head.py) against
the JAX package's Pallas kernels (onet_tpu/ops/pallas_head.py) run in
interpret mode on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions, so
this holds the plain arithmetic to the TPU kernels' contract (the card
kernels are held to the plain versions in tests/test_torch_card.py and
chip_smoke.py). Inputs come from a numpy seed. Tolerances: the loss rtol
1e-5 (f32 sums in another order); gradients 2e-4 of each one's largest
magnitude (the JAX package's own bound for its kernel against XLA); bf16
gradients 1e-2 of it (one bf16 rounding); min-max atol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import onet_tpu.ops.pallas_head as PH
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.ops import head as TH


def _feats(seed, shape=(2, 8, 16, 8)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jx(arrs, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _tx(arrs, dtype=torch.float32, grad=False):
    return [torch.tensor(a).to(dtype).requires_grad_(grad) for a in arrs]


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _launch_counts():
    return (TH.jsd_loss_fwd.launches, TH.jsd_loss_bwd.launches,
            TH.minmax_complement.launches)


def test_fused_loss_forward_matches_jax():
    feats = _feats(0)
    before = _launch_counts()
    loss = TH.fused_jsd_loss(*_tx(feats))
    jloss = PH.fused_jsd_loss(*_jx(feats))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # equals the model's compute_loss on the same features (the reference's
    # broadcast einsum), as the JAX docstring states
    lt, ht, ld, hd = _tx(feats)
    vt, vd = TO.channel_dot(lt, ht), TO.channel_dot(ld, hd)
    out = TO.OnetOutput(Lt=lt, Ld=ld, Vt=vt, Vd=vd,
                        S=torch.softmax(torch.stack([vt, vd], -1), -1))
    np.testing.assert_allclose(float(loss), float(TO.compute_loss(out)),
                               rtol=1e-5)
    assert _launch_counts() == before       # CPU: no kernel launch


def test_fused_loss_grads_match_jax():
    feats = _feats(1)
    ts = _tx(feats, grad=True)
    before = _launch_counts()
    grads = torch.autograd.grad(TH.fused_jsd_loss(*ts), ts)
    jgrads = jax.grad(PH.fused_jsd_loss, argnums=(0, 1, 2, 3))(*_jx(feats))
    assert _launch_counts() == before
    for g, jg, name in zip(grads, jgrads, ("Lt", "Ht", "Ld", "Hd")):
        assert g.dtype == torch.float32
        assert _rel_err(g.numpy(), jg) < 2e-4, name


def test_fused_loss_cotangent_scales_the_gradients():
    """The backward takes dloss as a tensor; 3 * loss has 3x the grads."""
    ts = _tx(_feats(2), grad=True)
    g1 = torch.autograd.grad(TH.fused_jsd_loss(*ts), ts)
    g3 = torch.autograd.grad(3.0 * TH.fused_jsd_loss(*ts), ts)
    for a, b in zip(g1, g3):
        assert _rel_err(b.numpy(), 3.0 * a.numpy()) < 1e-6


def test_fused_loss_bf16_inputs():
    feats = _feats(3)
    ts = _tx(feats, torch.bfloat16, grad=True)
    loss = TH.fused_jsd_loss(*ts)
    grads = torch.autograd.grad(loss, ts)
    jfeats = _jx(feats, jnp.bfloat16)
    jloss = PH.fused_jsd_loss(*jfeats)
    jgrads = jax.grad(PH.fused_jsd_loss, argnums=(0, 1, 2, 3))(*jfeats)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg, name in zip(grads, jgrads, ("Lt", "Ht", "Ld", "Hd")):
        assert g.dtype == torch.bfloat16
        assert jg.dtype == jnp.bfloat16
        assert _rel_err(g.float().numpy(), jg) < 1e-2, name


@pytest.mark.parametrize("shape", [(1, 3, 5, 8), (3, 1, 7, 5)])
def test_fused_loss_any_pixel_count(shape):
    """Pixel counts with no multiple-of-8 divisor: the JAX forward falls
    back to XLA and its fused backward raises; the port computes both. Held
    to the JAX package's _xla_loss and jax.grad of it."""
    feats = _feats(4, shape)
    ts = _tx(feats, grad=True)
    loss = TH.fused_jsd_loss(*ts)
    grads = torch.autograd.grad(loss, ts)
    jloss = PH._xla_loss(*_jx(feats))
    jgrads = jax.grad(PH._xla_loss, argnums=(0, 1, 2, 3))(*_jx(feats))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg, name in zip(grads, jgrads, ("Lt", "Ht", "Ld", "Hd")):
        assert _rel_err(g.numpy(), jg) < 2e-4, name
    with pytest.raises(NotImplementedError):
        jax.grad(PH.fused_jsd_loss)(*_jx(feats))


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """The recompute formulas against autograd of the plain forward (the
    derivative of log1pexp is sigmoid wherever these values land)."""
    ts = _tx(_feats(5), grad=True)
    auto = torch.autograd.grad(TH.jsd_loss_fwd_plain(*ts), ts)
    npix = ts[0].numel() // ts[0].shape[-1]
    hand = TH.jsd_loss_bwd_plain(*(t.detach() for t in ts),
                                 torch.tensor(1.0 / (2 * npix)))
    for a, h in zip(auto, hand):
        assert _rel_err(h.numpy(), a.numpy()) < 1e-5


@pytest.mark.parametrize("shape", [(3, 8, 16, 1), (2, 6, 10, 2)])
def test_minmax_complement_matches_jax(shape):
    """Per-frame min/max over (H, W, C): the C=2 frame shares one range."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 7, size=shape).astype(np.float32)
    x[..., -1] *= 0.3        # for C=2: channel 1 spans a third of the range
    before = _launch_counts()
    xn, xc = TH.minmax_complement(torch.tensor(x))
    jn, jc = PH.minmax_complement(jnp.asarray(x))
    pair = TH.paired_input(torch.tensor(x))
    jpair = PH.paired_input(jnp.asarray(x))
    assert _launch_counts() == before
    assert xn.dtype == xc.dtype == torch.float32 and xn.shape == x.shape
    np.testing.assert_allclose(xn.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(xc.numpy(), np.asarray(jc), atol=1e-6)
    assert pair.shape == (2 * shape[0],) + shape[1:]
    np.testing.assert_allclose(pair.numpy(), np.asarray(jpair), atol=1e-6)
    np.testing.assert_array_equal(pair.numpy(),
                                  torch.cat([xn, xc]).numpy())
    if shape[-1] == 2:   # one range for both channels, not one per channel
        assert float(xn[..., 1].amax()) < 0.5


def test_minmax_bf16_keeps_the_dtype():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 3, size=(2, 8, 8, 1)).astype(np.float32)
    xn, xc = TH.minmax_complement(torch.tensor(x).to(torch.bfloat16))
    jn, jc = PH.minmax_complement(jnp.asarray(x).astype(jnp.bfloat16))
    assert xn.dtype == xc.dtype == torch.bfloat16
    np.testing.assert_array_equal(xn.float().numpy(),
                                  np.asarray(jn, np.float32))
    np.testing.assert_array_equal(xc.float().numpy(),
                                  np.asarray(jc, np.float32))


def test_wrappers_reject_bad_inputs():
    f = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError):
        TH.fused_jsd_loss(f, f, f, torch.zeros(2, 4, 4, 4))
    with pytest.raises(ValueError):
        TH.minmax_complement(torch.zeros(4, 4))
