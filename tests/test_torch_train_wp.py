"""The port's pair-packed training path (onet_tpu_torch/models/wp.py:
unet_apply_wp with conv3x3_wp/conv3x3_wp2, the kernel-stats BatchNorm and
pool_wp) against the JAX package's, on the CPU in fp32.

Base 64 (the wp geometry), weights from the JAX init through the bridge,
frames [2, 32, 32, 1] from a numpy seed; JAX runs its Pallas kernels in
interpret mode, the port its plain versions. At 16x16 the deepest level is
1x1 and BatchNorm there normalizes 2 values per branch: JAX's own stacked
and wp gradients then differ by up to 13% on single leaves, so the frames
are 32x32, as in tests/test_wp_path.py.

The gradient of this net is ill-conditioned in float32: BatchNorm over the
few values of the deep levels amplifies summation-order noise, so a float32
gradient can be off the exact one by percents on some leaves. The witness
for every gradient leaf is therefore the JAX package's own stacked path in
float64 (``truth``: x64, with its float32 pins raised to float64 for the
call). Against it, on these frames (seed 5), the port's wp and stacked
float32 gradients are within 1.9e-5 of each leaf's largest magnitude and
JAX's wp float32 gradient within 1.5e-2; with frames from seed 3, JAX's
wp gradient is off by up to 16% and the port's wp gradient by up to 18%,
on other leaves, while the port's stacked one stays within 2.3e-5. Run
this file as a script to print these deviations for a seed.

Tolerances: forward S within 1e-4, Lsum and the new BN state within 1e-4 of
their largest magnitudes (float32 reassociation); loss within 1e-4
relative. Gradients: every leaf within 1e-3 of its largest magnitude of the
float64 witness (the per-leaf bound of tests/test_torch_train.py), and of
the port's own stacked path; against JAX's float32 wp gradient as one
vector, cosine > 0.9999 and relative L2 < 2e-2, the contract
tests/test_wp_path.py holds the JAX package's wp path to against its
stacked path. The train step: loss within 1e-4, BN state within 1e-4. One
Adam step from zero moments moves each parameter by
-lr * g / (|g| + eps), about -lr * sign(g): |update| <= lr everywhere, and
on every leaf the update is within 1e-2 of lr of the one the float64
gradient gives wherever that gradient exceeds 1e-2 of the leaf's largest
magnitude, and of JAX's wherever it also exceeds twice JAX's float32 error
on that leaf (where the sign is certain in both frameworks).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import onet_tpu.core.policy as JP
import onet_tpu.models.onet as JO
import onet_tpu.models.wp as JW
import onet_tpu.ops.pallas_conv as PC
from onet_tpu.train import optim as JOpt

from onet_tpu_torch.core.bridge import adam_state_from_jax, from_jax_numpy
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.models import wp as TW
from onet_tpu_torch.models.unet import tree_leaves, tree_map
from onet_tpu_torch.ops import conv_wp as TC
from onet_tpu_torch.train.steps import make_train_step

LR = 1e-5


def _np(t):
    return jax.tree.map(lambda a: np.array(a, copy=True), t)


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def _vec(leaves):
    return np.concatenate([np.ravel(np.asarray(a, np.float64))
                           for a in leaves])


def _close_vec(got, want, rel_l2, cos):
    a, b = _vec(want), _vec(got)
    assert np.linalg.norm(a - b) <= rel_l2 * np.linalg.norm(a)
    assert (a * b).sum() >= cos * np.linalg.norm(a) * np.linalg.norm(b)


def _close_leaves(got, want, rel=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12)


SEED = 5          # the frames' numpy seed


def _jax_case(seed):
    """The JAX wp path's loss, outputs, new state and gradient."""
    params, state = JO.onet_init(jax.random.key(0), 1)      # base 64
    x = np.random.default_rng(seed).uniform(0, 1, (2, 32, 32, 1)).astype(
        np.float32)
    old = PC.INTERPRET
    PC.INTERPRET = True
    try:
        @jax.jit
        def jf(p):
            out, ns = JO.onet_forward(p, state, jnp.asarray(x), train=True,
                                      pair_pack=True)
            return JO.compute_loss(out), (out.S, out.Lsum, ns)

        (jl, (js, jlsum, jns)), jg = jax.value_and_grad(
            jf, has_aux=True)(params)
    finally:
        PC.INTERPRET = old
    return dict(params=params, state=state, x=x, loss=float(jl),
                S=np.asarray(js), Lsum=np.asarray(jlsum), state_new=jns,
                grads=jg)


def _float64_gradient(case):
    """The loss and gradient leaves in float64: the JAX package's stacked
    path under x64, with jnp.float32 raised to float64 for the call so its
    float32 pins (BatchNorm, head, loss) hold float64 too."""
    f64 = jnp.float64
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", f64)
        policy = JP.Policy(param_dtype=f64, compute_dtype=f64,
                           norm_dtype=f64)
        cast = lambda t: jax.tree.map(                        # noqa: E731
            lambda a: jnp.asarray(a, f64), _np(t))
        state, x = cast(case["state"]), jnp.asarray(case["x"], f64)

        def jf(p):
            out, _ = JO.onet_forward(p, state, x, train=True, policy=policy,
                                     pair_pack=False)
            return JO.compute_loss(out)

        # jitted: op by op, the float64 backward compiles each primitive
        # jitted: op by op, the float64 backward compiles each primitive
        loss, g = jax.jit(jax.value_and_grad(jf))(cast(case["params"]))
        leaves = [np.asarray(a) for a in jax.tree.leaves(g)]
    assert loss.dtype == f64 and all(a.dtype == np.float64 for a in leaves)
    return dict(loss=float(loss), grads=leaves)


@pytest.fixture(scope="module")
def case():
    return _jax_case(SEED)


@pytest.fixture(scope="module")
def truth(case):
    return _float64_gradient(case)


def _port(case):
    return from_jax_numpy(_np(case["params"]), _np(case["state"]),
                          device="cpu")


def _port_forward(case, pair_pack=True):
    tp, ts = _port(case)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    counts = (TC.conv3x3_wp_raw.launches, TC.conv3x3_wp2_raw.launches,
              TC.conv3x3_wp_dw.launches)
    out, ns = TO.onet_forward(tp, ts, torch.tensor(case["x"]), train=True,
                              pair_pack=pair_pack)
    loss = TO.compute_loss(out)
    loss.backward()
    assert counts == (TC.conv3x3_wp_raw.launches,
                      TC.conv3x3_wp2_raw.launches,
                      TC.conv3x3_wp_dw.launches)    # CPU: plain versions
    return tp, out, ns, loss


def test_wp_train_forward_matches_jax(case):
    _, out, ns, _ = _port_forward(case)
    assert out.Lsum is not None and out.Lt.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(out.S.detach().numpy(), case["S"],
                               rtol=1e-4, atol=1e-4)
    _close_leaves([out.Lsum.detach().numpy()], [case["Lsum"]])
    _close_leaves([t.numpy() for t in tree_leaves(ns)],
                  _leaves(case["state_new"]))


def test_wp_loss_and_grads_match_jax(case, truth):
    tp, _, _, loss = _port_forward(case)
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-4)
    np.testing.assert_allclose(truth["loss"], case["loss"], rtol=1e-5)
    grads = [t.grad.numpy() for t in tree_leaves(tp)]
    _close_leaves(grads, truth["grads"], rel=1e-3)
    _close_vec(grads, _leaves(case["grads"]), rel_l2=2e-2, cos=0.9999)


def test_wp_and_stacked_train_paths_agree(case, truth):
    """The port against itself: the same contract as the JAX package's
    wp-vs-stacked test, and every gradient leaf of both paths against the
    float64 witness."""
    tp_w, out_w, ns_w, l_w = _port_forward(case, pair_pack=True)
    tp_s, out_s, ns_s, l_s = _port_forward(case, pair_pack=False)
    np.testing.assert_allclose(l_w.item(), l_s.item(), rtol=1e-4)
    np.testing.assert_allclose(out_w.S.detach().numpy(),
                               out_s.S.detach().numpy(), atol=2e-4,
                               rtol=1e-3)
    for a, b in zip(tree_leaves(ns_s), tree_leaves(ns_w)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-3)
    g_w = [t.grad.numpy() for t in tree_leaves(tp_w)]
    g_s = [t.grad.numpy() for t in tree_leaves(tp_s)]
    _close_vec(g_w, g_s, rel_l2=2e-2, cos=0.9999)
    _close_leaves(g_s, truth["grads"], rel=1e-3)
    _close_leaves(g_w, g_s, rel=1e-3)


def test_wp_eval_forward_matches_jax(case):
    old = PC.INTERPRET
    PC.INTERPRET = True
    try:
        jout, _ = jax.jit(lambda p: JO.onet_forward(
            p, case["state"], jnp.asarray(case["x"]), train=False,
            pair_pack=True))(case["params"])
    finally:
        PC.INTERPRET = old
    tp, ts = _port(case)
    with torch.no_grad():
        out, ns = TO.onet_forward(tp, ts, torch.tensor(case["x"]),
                                  train=False, pair_pack=True)
    np.testing.assert_allclose(out.S.numpy(), np.asarray(jout.S), rtol=1e-4,
                               atol=1e-4)
    _close_leaves([t.numpy() for t in tree_leaves(ns)],
                  [t.numpy() for t in tree_leaves(ts)], rel=0)


def _adam_first_update(g):
    """The parameter change of one Adam step from zero moments."""
    return -LR * g / (np.abs(g) + 1e-8)


def test_one_wp_train_step_matches_jax(case, truth, monkeypatch):
    """JAX's step is what its make_train_step runs, taken from the module
    fixture's own wp run: the loss, new BN state and gradient of
    value_and_grad on the pair-packed forward, then optax's Adam and
    params + updates."""
    monkeypatch.setattr(TO, "PAIR_PACK", True)
    params = case["params"]

    @jax.jit          # op by op, each leaf's shape would compile anew
    def adam_step(p, g):
        u, opt = JOpt.adam_update(g, JOpt.adam_init(p), LR)
        return jax.tree.map(lambda a, b: a + b, p, u), opt

    jp, jopt = adam_step(params, case["grads"])
    js, jl = case["state_new"], case["loss"]
    tp, ts = _port(case)
    p0 = tree_map(torch.clone, tp)
    topt0 = JOpt.adam_init(params)
    topt = adam_state_from_jax(topt0.count, _np(topt0.mu), _np(topt0.nu),
                               device="cpu")
    tp, ts, topt, tl = make_train_step()(tp, ts, topt,
                                         torch.tensor(case["x"]), LR)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(tl.item(), case["loss"], rtol=1e-4)
    p0l = [t.numpy().astype(np.float64) for t in tree_leaves(p0)]
    for tn, jn, p, jg, g64 in zip(tree_leaves(tp), _leaves(jp), p0l,
                                  _leaves(case["grads"]), truth["grads"]):
        t_delta, j_delta = tn.numpy() - p, jn - p
        assert np.abs(t_delta).max() <= LR * 1.01
        sure = np.abs(g64) > 1e-2 * np.abs(g64).max()
        np.testing.assert_allclose(t_delta[sure],
                                   _adam_first_update(g64)[sure], rtol=0,
                                   atol=1e-2 * LR)
        both = sure & (np.abs(g64) > 2 * np.abs(jg - g64).max())
        assert both.any()
        np.testing.assert_allclose(t_delta[both], j_delta[both], rtol=0,
                                   atol=1e-2 * LR)
    _close_leaves([t.numpy() for t in tree_leaves(ts)], _leaves(js))
    assert int(topt["count"]) == int(jopt.count) == 1


def test_pool_wp_backward_matches_jax():
    """First-match ties in window order (r0,c0), (r0,c1), (r1,c0),
    (r1,c1), c the parity lane block; ReLU zeros make whole windows tie."""
    rng = np.random.default_rng(31)
    x = np.maximum(rng.standard_normal((4, 6, 3, 128)), 0).astype(
        np.float32)
    x[0, :2, 0, :] = 0.0
    x[1, 2:4, 1, :64] = x[1, 2:4, 1, 64:]          # equal nonzero pairs
    g = rng.standard_normal((2, 3, 3, 128)).astype(np.float32)
    jy, vjp = jax.vjp(JW.pool_wp, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ty = TW.pool_wp(tx)
    ty.backward(torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))


def test_bn_apply_wp_and_its_vjp_match_jax():
    rng = np.random.default_rng(32)
    y = (1 + 2 * rng.standard_normal((4, 4, 3, 128))).astype(np.float32)
    dy = rng.standard_normal(y.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    s1 = y.sum(axis=(1, 2))
    s2 = np.square(y).sum(axis=(1, 2))
    cnt = 2 * 4 * 3 * 2
    jmean, jvar = JW._fold_stats(jnp.asarray(s1), jnp.asarray(s2), cnt)
    tmean, tvar = TW._fold_stats(torch.tensor(s1), torch.tensor(s2), cnt)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-6)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=1e-5)
    jinv = jax.lax.rsqrt(jvar + 1e-5)
    jout, vjp = jax.vjp(lambda y, s, b: JW.bn_apply_wp(y, s, b, jmean, jinv,
                                                       1e-5),
                        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(bias))
    jgrads = vjp(jnp.asarray(dy))
    ty, ts_, tb = (torch.tensor(a, requires_grad=True)
                   for a in (y, scale, bias))
    out = TW._BnApplyWp.apply(ty, ts_, tb, tmean, torch.rsqrt(tvar + 1e-5))
    out.backward(torch.tensor(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    _close_leaves([ty.grad.numpy(), ts_.grad.numpy(), tb.grad.numpy()],
                  [np.asarray(g) for g in jgrads], rel=1e-5)


if __name__ == "__main__":
    # Each float32 gradient's largest deviation from the float64 witness,
    # relative to the leaf's largest magnitude, over the leaves:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. \
    #       python tests/test_torch_train_wp.py [seed]
    import sys

    c = _jax_case(int(sys.argv[1]) if len(sys.argv) > 1 else SEED)
    want = _float64_gradient(c)["grads"]
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(c["params"])]
    runs = {"JAX wp": _leaves(c["grads"])}
    for name, pp in (("port wp", True), ("port stacked", False)):
        runs[name] = [t.grad.numpy() for t in
                      tree_leaves(_port_forward(c, pair_pack=pp)[0])]
    for name, got in runs.items():
        dev = [np.abs(g - w).max() / np.abs(w).max()
               for g, w in zip(got, want)]
        i = int(np.argmax(dev))
        print(f"{name:13s} {dev[i]:.2e} at {paths[i]}")
