"""The port's int8 training arithmetic (onet_tpu_torch/models/qtrain.py)
against the JAX package's (onet_tpu/models/qtrain.py), on the CPU, and
its accuracy gate.

Setup: base 8, 32x32 frames with bright blobs, made with numpy; weights
drawn by the port and carried to JAX as numpy. Tolerances:
* ``conv3x3_q``'s forward (f32 compute) within 1 ulp of JAX's run op by
  op: the same int8 codes and int32 sums, y = acc * (sx sw) (jitted XLA
  multiplies by the reciprocal of 127 where both divide, 2 ulps apart);
* its dx and dw against JAX's ``custom_vjp``: both are bf16 convs (dx
  from the int8 conv with ``fwd+dx``) of the same dequantized values,
  summed in other orders and rounded to bf16: within 2e-2 of the
  largest magnitude (about two bf16 roundings);
* ``make_train_step(quantized=...)``: 3 Adam steps from the same weights
  and BN state, losses within rtol 1e-3 of JAX's (the steps' float32
  arithmetic differs in order; int8 rounding ties can flip a code);
* the gate (the JAX package's ``test_quantized_training_gate``, run on
  the port): 25 steps of exact and int8 training from one init, the last
  losses within rtol 0.08 and the masks agreeing as closely as an exact
  run under a 1e-5 weight jitter, and at least 0.9.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from onet_tpu.models import qtrain as JT
from onet_tpu.train.optim import adam_init as j_adam
from onet_tpu.train.steps import make_train_step as j_train_step

from onet_tpu_torch.models import qtrain as TT
from onet_tpu_torch.models.onet import onet_init
from onet_tpu_torch.models.unet import DEFAULT_OPS, tree_map
from onet_tpu_torch.ops import conv_i8 as CI
from onet_tpu_torch.train.optim import adam_init
from onet_tpu_torch.train.simclutter import SimclutterConfig, train
from onet_tpu_torch.train.steps import make_eval_step, make_train_step

DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 32, 32, 1)).astype(np.float32)
    x[:, 8:16, 8:16, :] += 1.5
    return np.clip(x, 0, 1)


def _conv_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 8)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    return x, w, dy


def test_conv_q_forward_matches_jax():
    x, w, _ = _conv_inputs()
    with jax.disable_jit():        # op by op: jitted XLA multiplies by
        y_j = JT.conv3x3_q(            # 1/127 where this divides (2 ulps)
            jnp.asarray(x), jnp.asarray(w), jnp.float32, False)
    y = TT.conv3x3_q(torch.from_numpy(x), torch.from_numpy(w),
                     torch.float32, False)
    assert y.dtype == torch.float32
    np.testing.assert_array_max_ulp(y.numpy(), np.asarray(y_j), maxulp=1)
    ref = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1),
                                   "SAME", dimension_numbers=DN)
    rel = float(np.linalg.norm(y.numpy() - np.asarray(ref))
                / np.linalg.norm(np.asarray(ref)))
    assert rel < 0.02, rel


@pytest.mark.parametrize("level", ["fwd", "fwd+dx"])
def test_conv_q_gradients_match_jax(level):
    x, w, dy = _conv_inputs()
    dx_int8 = level == "fwd+dx"

    def fwd(a, b):
        return JT.conv3x3_q(a, b, jnp.float32, dx_int8)

    _, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    launches = CI.conv3x3_i8.launches
    y = TT.conv3x3_q(xt, wt, torch.float32, dx_int8)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    assert CI.conv3x3_i8.launches == launches    # CPU: the plain version
    assert dx.dtype == dw.dtype == torch.float32
    for got, ref in ((dx, dx_j), (dw, dw_j)):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), (level, err)


def test_dx_conv_skipped_without_input_gradient(monkeypatch):
    """The first conv's input needs no gradient: its dx conv is not run
    (one int8 conv forward, none backward)."""
    calls = []
    real = TT.conv3x3_i8
    monkeypatch.setattr(TT, "conv3x3_i8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w, dy = _conv_inputs()
    wt = torch.from_numpy(w).requires_grad_(True)
    for xt, want in ((torch.from_numpy(x), 1),
                     (torch.from_numpy(x).requires_grad_(True), 2)):
        calls.clear()
        y = TT.conv3x3_q(xt, wt, torch.float32, True)
        y.backward(torch.from_numpy(dy))
        assert len(calls) == want


def test_qtrain_ops_namespace():
    ops = TT.make_qtrain_ops(level="fwd")
    assert callable(ops.conv3x3) and callable(ops.batch_norm)
    assert ops.max_pool is DEFAULT_OPS.max_pool
    with pytest.raises(AssertionError):
        TT.make_qtrain_ops(level="everything")


@pytest.fixture(scope="module")
def init():
    """Port weights (seeded) and their numpy copies for JAX."""
    p, s = onet_init(torch.Generator().manual_seed(0), 1, base=8,
                     device="cpu")
    to_np = lambda t: tree_map(lambda a: a.numpy().copy(), t)  # noqa: E731
    return (p, s), (to_np(p), to_np(s))


def _clone(tree):
    return tree_map(torch.clone, tree)


@pytest.mark.parametrize("level", ["fwd", "fwd+dx"])
def test_quantized_train_step_tracks_jax(init, level):
    (p0, s0), (pn, sn) = init
    x = _blobs(8)
    jp = jax.tree.map(jnp.asarray, pn)
    jb = jax.tree.map(jnp.asarray, sn)
    jo = j_adam(jp)
    jstep = j_train_step(quantized=level)
    p, s = _clone(p0), _clone(s0)
    o = adam_init(p)
    step = make_train_step(quantized=level)
    for _ in range(3):
        jp, jb, jo, jl = jstep(jp, jb, jo, jnp.asarray(x), 1e-3)
        p, s, o, loss = step(p, s, o, torch.from_numpy(x), 1e-3)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)


def _run_gate(init, quantized, jitter=0.0):
    """25 Adam steps at lr 1e-3 on the blob frames from the shared init:
    (masks of an eval step, losses)."""
    (params, bn), _ = init
    x = torch.from_numpy(_blobs(8))
    p = _clone(params)
    if jitter:
        g = torch.Generator().manual_seed(9)
        p = tree_map(lambda a: a + jitter * torch.randn(a.shape, generator=g),
                     p)
    b = _clone(bn)
    o = adam_init(p)
    step = make_train_step(quantized=quantized)
    losses = []
    for _ in range(25):
        p, b, o, loss = step(p, b, o, x, 1e-3)
        losses.append(float(loss))
    labels = (x[..., 0] > 0.9).to(torch.int32)
    _, _, pred = make_eval_step(align="none")(p, b, x, labels)
    return pred, losses


@pytest.fixture(scope="module")
def exact_runs(init):
    """The exact run and the exact run under a 1e-5 weight jitter, shared
    by both levels of the gate."""
    return _run_gate(init, None), _run_gate(init, None, jitter=1e-5)


@pytest.mark.parametrize("level", ["fwd", "fwd+dx"])
def test_quantized_training_gate(init, exact_runs, level):
    """Train exact and int8 from the same init on the same batches: losses
    must track and the final models must agree on masks (the JAX
    package's tests/test_qtrain.py, on the port). Self-calibrating bar:
    the int8 run may not diverge from the exact one much further than an
    exact run under an fp-noise-level jitter does."""
    (pred_e, l_e), (pred_j, _) = exact_runs
    pred_q, l_q = _run_gate(init, level)
    assert np.all(np.isfinite(l_q)), l_q
    np.testing.assert_allclose(l_q[-1], l_e[-1], rtol=0.08)
    agree = float((pred_e == pred_q).float().mean())
    agree_ref = float((pred_e == pred_j).float().mean())
    assert agree >= min(agree_ref - 0.02, 0.99), (level, agree, agree_ref)
    assert agree >= 0.9, (level, agree)


def test_simclutter_driver_trains_quantized(tmp_path, monkeypatch):
    """SimclutterConfig.quantized reaches the train step: one epoch at
    base 8 on 16x16 frames, int8 forward and input gradient."""
    cfg = SimclutterConfig(quantized="fwd+dx", base_channels=8, input_sz=16,
                           frames_per_level=4, epoch_nums=1, batch_sz=4,
                           low_snr=0, high_snr=0, out_root=str(tmp_path),
                           save_epochs=())
    calls = []
    real = TT.conv3x3_i8
    monkeypatch.setattr(TT, "conv3x3_i8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, hist = train(cfg, log=False, device="cpu")
    assert np.isfinite(hist["loss"][0])
    # 18 int8 forward convs and 17 int8 dx convs a step
    assert len(calls) % 35 == 0 and calls
