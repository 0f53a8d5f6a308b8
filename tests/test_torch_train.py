"""The port's training side (onet_tpu_torch: layers, unet, onet, optim,
metrics, train/steps) against the JAX package on the CPU, in fp32.

Weights are drawn by the port's init (the JAX init's laws; JAX's own init
runs op by op for ~30 s) and go to both packages as the same float32
arrays, crossing into the port through its bridge; inputs and cotangents
come from numpy seeds. Base 8 at 32x32. Tolerances: float32
reassociation (the two frameworks sum the same terms in other orders) —
1e-5 relative on the loss; BN state, S and per-layer outputs within 1e-4;
every gradient leaf within 1e-3 of that leaf's largest magnitude (the
reassociation noise of ~20 stacked layers, each renormalized by BatchNorm;
measured at 4e-5 to 9e-5 on the JAX init's weights, where the port in
float32 is within 1e-5 of itself in float64). Some seeds make the shallow gradients of a net
ill-conditioned (float32 then differs from float64 by 1%), and no float32
comparison can be tight there; the seeds here are not such cases.

Train steps (batch 4, so each of 2 microbatches keeps 2 samples per
branch): loss per step within 1e-5, BN state and the Adam moments mu, nu
(linear in the gradients) within 1e-2 relative L2 over the whole tree. The
parameter updates are held as one vector, cosine > 0.999 and relative L2 <
5e-2: Adam divides each element by its own root mean square, so an element
whose gradient is within float32 noise of zero moves by +-lr in either
framework, whatever the sign it lands on.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.metrics import segmentation as JM
from onet_tpu.models import layers as JL
from onet_tpu.models import onet as JO
from onet_tpu.ops.math import log1pexp as j_log1pexp
from onet_tpu.train import optim as JOpt
from onet_tpu.train.steps import (make_eval_step as j_make_eval_step,
                                  make_train_step as j_make_train_step)

from onet_tpu_torch.core.bridge import adam_state_from_jax, from_jax_numpy
from onet_tpu_torch.metrics import segmentation as TM
from onet_tpu_torch.models import layers as TL
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.models.unet import tree_leaves, tree_map
from onet_tpu_torch.ops.math import log1pexp
from onet_tpu_torch.train import optim as TOpt
from onet_tpu_torch.train.steps import make_eval_step, make_train_step

LR = 1e-5         # bench.py's learning rate


def _np(t):
    return jax.tree.map(lambda a: np.array(a, copy=True), t)


def _jax_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _close_tree(got, want, rel_l2=1e-2, cos=0.9999):
    """The leaves as one vector: relative L2 error and cosine."""
    a = np.concatenate([np.ravel(np.asarray(w, np.float64)) for w in want])
    b = np.concatenate([np.ravel(np.asarray(g, np.float64)) for g in got])
    assert np.linalg.norm(a - b) <= rel_l2 * np.linalg.norm(a)
    assert (a * b).sum() >= cos * np.linalg.norm(a) * np.linalg.norm(b)


def _close_leaves(got, want, rel=1e-3):
    """Every leaf within ``rel`` of its largest magnitude."""
    got, want = ([t.detach().numpy() if isinstance(t, torch.Tensor) else t
                  for t in leaves] for leaves in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12)


@pytest.fixture(scope="module")
def model():
    """Weights drawn by the port's init (the JAX init's laws; JAX's eager
    init compiles op by op for ~30 s), as JAX arrays for both packages."""
    def init(**kw):
        return jax.tree.map(
            lambda t: jnp.asarray(t.numpy()),
            TO.onet_init(torch.Generator().manual_seed(0), 1, base=8,
                         device="cpu", **kw))

    params, state = init()
    twin = init(weight_share=False)
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 1)).astype(
        np.float32)
    return {"shared": (params, state), "twin": twin, "x": x}


def _port(params, state):
    return from_jax_numpy(_np(params), _np(state), device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

BN_CASES = {
    "block": dict(groups=2, shape=(4, 6, 6, 8)),
    "interleaved": dict(groups=2, interleaved=True, shape=(4, 6, 6, 8)),
    "stacked": dict(groups=2, stacked=True, shape=(2, 6, 6, 16)),
    "single": dict(groups=1, shape=(3, 6, 6, 8)),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_train_matches_jax(case):
    """y, the new running state and the gradients of (x, scale, bias)."""
    cfg = dict(BN_CASES[case])
    shape = cfg.pop("shape")
    rng = np.random.default_rng(11)
    x = (2 + 3 * rng.standard_normal(shape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}
    s = {"mean": (0.1 * rng.standard_normal(8)).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}

    def jf(x, scale, bias):
        return JL.batch_norm(x, {"scale": scale, "bias": bias},
                             jax.tree.map(jnp.asarray, s), train=True,
                             **cfg)

    (jy, jst), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(p["scale"]),
                             jnp.asarray(p["bias"]))
    jgrads = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, jst)))

    tx, tsc, tb = (torch.tensor(a, requires_grad=True)
                   for a in (x, p["scale"], p["bias"]))
    ty, tst = TL.batch_norm(tx, {"scale": tsc, "bias": tb},
                            tree_map(torch.tensor, s), train=True, **cfg)
    ty.backward(torch.tensor(dy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    for k in ("mean", "var"):
        assert not tst[k].requires_grad
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-5, atol=1e-6)
    _close_leaves([tx.grad, tsc.grad, tb.grad],
                  [np.asarray(g) for g in jgrads], rel=1e-4)


@pytest.mark.parametrize("stacked", [False, True])
def test_batch_norm_eval_matches_jax(stacked):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 5, 16 if stacked else 8)).astype(
        np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
         "bias": rng.standard_normal(8).astype(np.float32)}
    s = {"mean": rng.standard_normal(8).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    jy, _ = JL.batch_norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                          jax.tree.map(jnp.asarray, s), train=False,
                          groups=2, stacked=stacked)
    ty, tst = TL.batch_norm(torch.tensor(x), tree_map(torch.tensor, p),
                            tree_map(torch.tensor, s), train=False,
                            groups=2, stacked=stacked)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tst["var"].numpy(), s["var"])


def test_max_pool_ties_route_to_the_first_maximum():
    """ReLU zeros make whole windows tie: both frameworks send the
    window's gradient to its first element in scan order."""
    rng = np.random.default_rng(13)
    x = np.maximum(rng.standard_normal((2, 6, 6, 4)), 0).astype(np.float32)
    x[0, :2, :2, :] = 0.0                              # an all-zero window
    g = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    _, vjp = jax.vjp(JL.max_pool_2x2, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    TL.max_pool_2x2(tx).backward(torch.tensor(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))
    assert tx.grad[0, 0, 0, 0] == g[0, 0, 0, 0]
    assert (tx.grad[0, :2, :2, 0].numpy() != 0).sum() == 1


def test_log1pexp_at_the_branch_edges():
    pts = np.array([-60, -40, -37.0001, -37, -36.9999, -1, 0, 1, 17.9999, 18,
                    18.0001, 33.2999, 33.3, 33.3001, 40, 60], np.float32)
    jv, jg = jax.vmap(jax.value_and_grad(j_log1pexp))(jnp.asarray(pts))
    tx = torch.tensor(pts, requires_grad=True)
    tv = log1pexp(tx)
    tv.sum().backward()
    assert torch.isfinite(tv).all() and torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=0)


def test_jsd_loss_pair_and_its_gradient():
    """The hand-written backward (sigmoid), not autograd of log1pexp."""
    rng = np.random.default_rng(14)
    lsum = (10 * rng.standard_normal((2, 8, 8, 2))).astype(np.float32)
    s = rng.uniform(0, 1, (2, 8, 8, 2)).astype(np.float32)
    jl, (jdl, jds) = jax.value_and_grad(JO._jsd_loss_pair, argnums=(0, 1))(
        jnp.asarray(lsum), jnp.asarray(s))
    tl_, ts = (torch.tensor(a, requires_grad=True) for a in (lsum, s))
    loss = TO.jsd_loss_pair(tl_, ts)
    loss.backward(torch.tensor(3.0))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tl_.grad.numpy(), 3 * np.asarray(jdl),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(ts.grad.numpy(), 3 * np.asarray(jds),
                               rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

FWD_CASES = {
    "stacked": dict(opts={}),
    "stacked_dp_local": dict(opts=dict(dp_local=True)),
    "batch_stacked": dict(opts=dict(channel_stack=False)),
    "twin": dict(opts={}, twin=True),
    "stacked_rsn": dict(opts={}, loss="rsn"),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_onet_forward_loss_and_grads_match_jax(model, case):
    cfg = FWD_CASES[case]
    params, state = model["twin" if cfg.get("twin") else "shared"]
    x = model["x"]
    j_loss_of = JO.LOSSES[cfg.get("loss", "jsd")]

    @jax.jit
    def jf(p):
        out, ns = JO.onet_forward(p, state, jnp.asarray(x), train=True,
                                  **cfg["opts"])
        return j_loss_of(out), (out.S, ns)

    (jl, (js, jns)), jg = jax.value_and_grad(jf, has_aux=True)(params)

    tp, ts = _port(params, state)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    out, ns = TO.onet_forward(tp, ts, torch.tensor(x), train=True,
                              **cfg["opts"])
    loss = TO.LOSSES[cfg.get("loss", "jsd")](out)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(out.S.detach().numpy(), np.asarray(js),
                               rtol=1e-4, atol=1e-4)
    _close_leaves(tree_leaves(ns), _jax_leaves(jns), rel=1e-4)
    _close_leaves([t.grad for t in tree_leaves(tp)], _jax_leaves(jg))


def test_eval_forward_keeps_the_state(model):
    params, state = model["shared"]
    tp, ts = _port(params, state)
    with torch.no_grad():
        out, ns = TO.onet_forward(tp, ts, torch.tensor(model["x"]),
                                  train=False)
    jout, _ = jax.jit(JO.onet_forward, static_argnames=("train",))(
        params, state, jnp.asarray(model["x"]), train=False)
    _close_leaves(tree_leaves(ns), tree_leaves(ts), rel=0)
    np.testing.assert_allclose(out.S.numpy(), np.asarray(jout.S), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# optimizer and steps
# ---------------------------------------------------------------------------

def test_adam_state_bridge_and_update_match_optax():
    rng = np.random.default_rng(15)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JOpt.adam_init(jp)
    tstate = adam_state_from_jax(jstate.count, _np(jstate.mu),
                                 _np(jstate.nu), device="cpu")
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 0
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jp)
        ju, jstate = JOpt.adam_update(g, jstate, LR)
        tu, tstate = TOpt.adam_update(tree_map(torch.tensor, _np(g)), tstate,
                                      LR)
        _close_leaves(tree_leaves(tu), _jax_leaves(ju), rel=1e-6)
    assert int(tstate["count"]) == int(jstate.count) == 3
    _close_leaves(tree_leaves(tstate["mu"]), _jax_leaves(jstate.mu), 1e-6)
    _close_leaves(tree_leaves(tstate["nu"]), _jax_leaves(jstate.nu), 1e-6)
    again = adam_state_from_jax(jstate.count, _np(jstate.mu),
                                _np(jstate.nu), device="cpu")
    assert int(again["count"]) == 3
    _close_leaves(tree_leaves(again["nu"]), _jax_leaves(jstate.nu), 0)


def test_schedules_and_freeze_match_jax():
    for epoch in (0, 99, 100, 250, 299, 300, 900, 2000):
        assert TOpt.step_decay(1e-3, epoch) == JOpt.step_decay(1e-3, epoch)
        assert TOpt.cosine_warm_restarts(1e-3, epoch) == pytest.approx(
            JOpt.cosine_warm_restarts(1e-3, epoch), rel=1e-12)
    g = {"top": {"inc": {"w": np.ones(3, np.float32)},
                 "up4": {"w": np.ones(2, np.float32)}}}
    frozen = lambda path: "inc" in path          # noqa: E731
    jf = JOpt.freeze_params(jax.tree.map(jnp.asarray, g), frozen)
    tf = TOpt.freeze_params(tree_map(torch.tensor, g), frozen)
    _close_leaves(tree_leaves(tf), _jax_leaves(jf), rel=0)
    assert float(tf["top"]["inc"]["w"].sum()) == 0.0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_jax(model, microbatches):
    """3 steps of make_train_step from the same params, BN state and Adam
    state: loss each step, then params, BN state and optimizer state."""
    params, state = model["shared"]
    rng = np.random.default_rng(16)
    xs = [rng.uniform(0, 1, (4, 32, 32, 1)).astype(np.float32)
          for _ in range(3)]
    jopt = JOpt.adam_init(params)
    tp, ts = _port(params, state)
    topt = adam_state_from_jax(jopt.count, _np(jopt.mu), _np(jopt.nu),
                               device="cpu")
    p0 = tree_map(torch.clone, tp)
    jstep = j_make_train_step(microbatches=microbatches)
    tstep = make_train_step(microbatches=microbatches)
    jp, js = jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, state)
    for x in xs:
        jp, js, jopt, jl = jstep(jp, js, jopt, jnp.asarray(x), LR)
        tp, ts, topt, tl_ = tstep(tp, ts, topt, torch.tensor(x), LR)
        np.testing.assert_allclose(float(tl_), float(jl), rtol=1e-5)
    j_delta = [a - b.numpy() for a, b in zip(_jax_leaves(jp),
                                             tree_leaves(p0))]
    t_delta = [a.numpy() - b.numpy() for a, b in zip(tree_leaves(tp),
                                                     tree_leaves(p0))]
    assert max(np.abs(d).max() for d in t_delta) <= 3 * LR * 1.01
    _close_tree(t_delta, j_delta, rel_l2=5e-2, cos=0.999)
    _close_leaves(tree_leaves(ts), _jax_leaves(js), rel=1e-4)
    assert int(topt["count"]) == int(jopt.count) == 3
    _close_tree([t.numpy() for t in tree_leaves(topt["mu"])],
                _jax_leaves(jopt.mu), cos=0.9999)
    _close_tree([t.numpy() for t in tree_leaves(topt["nu"])],
                _jax_leaves(jopt.nu), cos=0.9999)


@pytest.mark.parametrize("align", ["flip", "hungarian", "none"])
def test_eval_step_matches_jax(model, align):
    params, state = model["shared"]
    x = model["x"]
    labels = (x[..., 0] > 0.5).astype(np.int32)
    jm, jl, jpred = j_make_eval_step(align=align)(
        params, state, jnp.asarray(x), jnp.asarray(labels))
    tp, ts = _port(params, state)
    tm, tl_, tpred = make_eval_step(align=align)(
        tp, ts, torch.tensor(x), torch.tensor(labels))
    np.testing.assert_allclose(float(tl_), float(jl), rtol=1e-5)
    agree = float((tpred.numpy() == np.asarray(jpred)).mean())
    assert agree >= 0.999, agree
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-3)


def test_steps_refuse_what_is_not_ported(model):
    """What the step builders refuse is what the JAX package refuses:
    int8 or spatial training on another backbone. A mesh of one rank (no
    process group) gives the plain steps' results bit for bit, and
    ``spatial`` without a mesh changes nothing, as in JAX. Many-rank
    meshes: tests/test_torch_parallel.py."""
    from onet_tpu_torch.core.mesh import make_mesh
    for kw in (dict(spatial=True, forward=lambda *a, **k: None),
               dict(quantized="fwd", forward=lambda *a, **k: None)):
        with pytest.raises(ValueError):
            make_train_step(**kw)
    params, state = model["shared"]
    x = torch.tensor(model["x"])
    labels = (x[..., 0] > 0.5).to(torch.int32)
    mesh = make_mesh((1, 1), ("data", "space"))
    got = [make_train_step(**kw).loss_and_grads(*_port(params, state), x)
           for kw in (dict(), dict(mesh=mesh), dict(spatial=True),
                      dict(mesh=mesh, spatial=True))]
    for v, bn, g in got[1:]:
        assert torch.equal(v, got[0][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(g), tree_leaves(got[0][2])))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(bn), tree_leaves(got[0][1])))
    m0, v0, p0 = make_eval_step()(*_port(params, state), x, labels)
    m1, v1, p1 = make_eval_step(mesh=mesh)(*_port(params, state), x, labels)
    assert torch.equal(v0, v1) and torch.equal(p0, p1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "all_background", "perfect",
                                  "inverted"])
def test_segmentation_metrics_match_jax(kind):
    rng = np.random.default_rng(17)
    target = (rng.uniform(size=(2, 16, 16)) > 0.7).astype(np.int32)
    pred = {"random": (rng.uniform(size=(2, 16, 16)) > 0.6).astype(np.int32),
            "all_background": np.zeros_like(target),
            "perfect": target.copy(),
            "inverted": 1 - target}[kind]
    echos = rng.uniform(size=(2, 16, 16)).astype(np.float32)
    jp, jt, je = (jnp.asarray(a) for a in (pred, target, echos))
    tp, tt, te = (torch.tensor(a) for a in (pred, target, echos))
    jm = JM.evaluate_binary_segmentation(jp, jt)
    tm = TM.evaluate_binary_segmentation(tp, tt)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    for name in ("accuracy", "miou", "target_iou", "detection_rate",
                 "false_alarm_rate"):
        np.testing.assert_allclose(float(getattr(TM, name)(tp, tt)),
                                   float(getattr(JM, name)(jp, jt)),
                                   rtol=1e-6)
    for name in ("align_labels_by_accuracy", "align_labels_hungarian"):
        np.testing.assert_array_equal(getattr(TM, name)(tp, tt).numpy(),
                                      np.asarray(getattr(JM, name)(jp, jt)))
    np.testing.assert_allclose([float(v) for v in TM.psnr_snr(te, tt)],
                               [float(v) for v in JM.psnr_snr(je, jt)],
                               rtol=1e-5)
    np.testing.assert_array_equal(
        TM.reorder_by_mean_intensity(tp, te).numpy(),
        np.asarray(JM.reorder_by_mean_intensity(jp, je)))
    three = (pred + (rng.uniform(size=pred.shape) > 0.8)).astype(np.int32)
    for k, pk in ((2, pred), (3, three)):
        np.testing.assert_array_equal(
            TM.reorder_by_intensity(torch.tensor(pk), te, k).numpy(),
            np.asarray(JM.reorder_by_intensity(jnp.asarray(pk), je, k)))
    np.testing.assert_allclose(
        [float(v) for v in TM.evaluate_with_intensity_reorder(
            torch.tensor(three), tt, te)],
        [float(v) for v in JM.evaluate_with_intensity_reorder(
            jnp.asarray(three), jt, je)], rtol=1e-6)
