"""The port's native-layout conv (onet_tpu_torch/ops/conv_bd.py) against the
JAX package's Pallas kernels (onet_tpu/ops/pallas_conv_bd.py) run in
interpret mode on the CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions; this
holds them to the TPU kernels' contract. Inputs come from a numpy seed.
Tolerances: with ``out_dtype=float32`` y, s1 and s2 within 1e-5 of their
largest magnitude (both sides sum exact bf16 products in f32, in another
order); with the default bf16 output, y within 1e-2 of max|y| (one bf16
rounding); the library formulation (cuDNN/XLA conv, bf16 output, stats of
it) within 2e-2 of max|y| and 1e-2 of max|s| (bf16 roundings of y that may
fall apart by one ulp).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import onet_tpu.ops.pallas_conv_bd as PB
from onet_tpu.models.layers import bd2 as jbd2
from onet_tpu_torch.models.layers import bd2
from onet_tpu_torch.ops import conv_bd as TB
from onet_tpu_torch.runs import bd_epilogue_probe as probe


def _data(seed, shape):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    ws = [np.asarray(jbd2(jnp.asarray(
        (0.1 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32))))
        for _ in range(2)]
    return xs, ws


def _bf(a):
    """numpy f32 -> bf16 torch tensor (the inputs the kernel takes)."""
    return torch.tensor(a).to(torch.bfloat16)


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _counts():
    return TB.conv3x3_bd_raw.launches, TB.conv3x3_bd2in_raw.launches


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (1, 8, 8, 128)])
@pytest.mark.parametrize("nin", [1, 2])
@pytest.mark.parametrize("stats", [False, True])
def test_bd_conv_matches_jax(shape, nin, stats):
    xs, ws = _data(nin + 2 * len(shape) + shape[0], shape)
    before = _counts()
    kw = dict(stats=stats, out_dtype=torch.float32)
    jkw = dict(stats=stats, out_dtype=jnp.float32, interpret=True)
    if nin == 1:
        got = TB.conv3x3_bd_raw(_bf(xs[0]), _bf(ws[0]), **kw)
        ref = PB.conv3x3_bd_raw(_jbf(xs[0]), _jbf(ws[0]), **jkw)
    else:
        got = TB.conv3x3_bd2in_raw(*map(_bf, xs), *map(_bf, ws), **kw)
        ref = PB.conv3x3_bd2in_raw(*map(_jbf, xs), *map(_jbf, ws), **jkw)
    assert _counts() == before               # CPU: no kernel launch
    if not stats:
        got, ref = (got,), (ref,)
    assert got[0].dtype == torch.float32 and got[0].shape == shape
    for g, r, name in zip(got, ref, ("y", "s1", "s2")):
        assert g.shape == r.shape, name
        assert _rel_err(g.numpy(), r) < 1e-5, name


@pytest.mark.parametrize("nin", [1, 2])
def test_bd_conv_bf16_output(nin):
    xs, ws = _data(20 + nin, (2, 16, 16, 128))
    if nin == 1:
        y = TB.conv3x3_bd_raw(_bf(xs[0]), _bf(ws[0]))
        ry = PB.conv3x3_bd_raw(_jbf(xs[0]), _jbf(ws[0]), interpret=True)
    else:
        y = TB.conv3x3_bd2in_raw(*map(_bf, xs), *map(_bf, ws))
        ry = PB.conv3x3_bd2in_raw(*map(_jbf, xs), *map(_jbf, ws),
                                  interpret=True)
    assert y.dtype == torch.bfloat16 and ry.dtype == jnp.bfloat16
    assert _rel_err(y.float().numpy(), ry) < 1e-2


def test_bd_conv_casts_f32_inputs_to_bf16():
    """f32 x and w are rounded to bf16 first, as the JAX function does:
    the result equals the bf16-input result and JAX's on the f32 inputs."""
    xs, ws = _data(30, (1, 8, 8, 128))
    x32, w32 = torch.tensor(xs[0]), torch.tensor(ws[0])
    y, s1, s2 = TB.conv3x3_bd_raw(x32, w32, stats=True)
    assert y.dtype == torch.float32
    yb, s1b, s2b = TB.conv3x3_bd_raw(_bf(xs[0]), _bf(ws[0]), stats=True,
                                     out_dtype=torch.float32)
    for a, b in ((y, yb), (s1, s1b), (s2, s2b)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jy, js1, js2 = PB.conv3x3_bd_raw(jnp.asarray(xs[0]), jnp.asarray(ws[0]),
                                     stats=True, interpret=True)
    assert jy.dtype == jnp.float32
    for g, r in ((y, jy), (s1, js1), (s2, js2)):
        assert _rel_err(g.numpy(), r) < 1e-5
    y2 = TB.conv3x3_bd2in_raw(x32, torch.tensor(xs[1]), w32,
                              torch.tensor(ws[1]))
    jy2 = PB.conv3x3_bd2in_raw(*map(jnp.asarray, xs), *map(jnp.asarray, ws),
                               interpret=True)
    assert _rel_err(y2.numpy(), jy2) < 1e-5


def test_conv_stats_library_matches_xla_conv_stats():
    xs, ws = _data(40, (2, 16, 16, 128))
    y, s1, s2 = TB.conv_stats_library(_bf(xs[0]), _bf(ws[0]))
    jy, js1, js2 = PB.xla_conv_stats(_jbf(xs[0]), _jbf(ws[0]))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 16, 16, 128)
    assert _rel_err(y.float().numpy(), jy) < 2e-2
    assert _rel_err(s1.numpy(), js1) < 1e-2
    assert _rel_err(s2.numpy(), js2) < 1e-2
    # and the kernel's plain version sums the f32 accumulator, not y
    _, ps1, ps2 = TB.conv3x3_bd_raw(_bf(xs[0]), _bf(ws[0]), stats=True)
    assert _rel_err(ps1.numpy(), s1.numpy()) < 1e-2
    assert _rel_err(ps2.numpy(), s2.numpy()) < 1e-2


def test_probe_sites_agree_with_the_library_on_the_cpu():
    """The probe's site functions at a small size: kernel path (plain on
    the CPU) and library path give the same consumed scalar."""
    x, xb, w1, wa, wb = probe.inputs(torch.device("cpu"), b=2, h=16, w=16)
    assert x.dtype == torch.bfloat16 and w1.shape == (3, 3, 128, 128)
    # bd2 of the seeded taps: zero off-diagonal blocks
    assert not w1[:, :, :64, 64:].any() and not w1[:, :, 64:, :64].any()
    np.testing.assert_array_equal(w1.float().numpy(),
                                  bd2(w1[:, :, :64, :64]).float().numpy())
    for a, b in ((probe.site1(x, w1), probe.site1_library(x, w1)),
                 (probe.site2(x, xb, wa, wb),
                  probe.site2_library(x, xb, wa, wb))):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-2, atol=0.5)


def test_wrappers_reject_bad_shapes():
    w = torch.zeros(3, 3, 128, 128)
    with pytest.raises(ValueError):
        TB.conv3x3_bd_raw(torch.zeros(1, 4, 4, 64), w)
    with pytest.raises(ValueError):
        TB.conv3x3_bd_raw(torch.zeros(1, 4, 4, 128), w[:, :, :64])
    with pytest.raises(ValueError):
        TB.conv3x3_bd2in_raw(torch.zeros(1, 4, 4, 128),
                             torch.zeros(1, 4, 8, 128), w, w)
