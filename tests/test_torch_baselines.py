"""The port's comparison baselines (onet_tpu_torch/models/iic.py,
models/infoseg.py, train/iic.py, train/infoseg.py and their shared loop
train/baseline.py) against the JAX package's, on the CPU in float32.

Base 8, frames [3, 30, 34, 1] (odd and unequal sides: the nearest
upsample's edge rows and the shift bands both run) from a numpy seed. The
weights are drawn by the port's inits (JAX's laws: He normals, BN ones
and zeros) and fed to both packages. JAX's view draws (its ``PairMeta``
and gains, from a key) are carried into the port through
``iic_pair_from``: the two packages cannot draw the same views.

Tolerances: views, the undo-geometry maps and the validity mask
bit-equal; forward probabilities within atol 2e-5 / rtol 1e-4; joints,
MI and losses within 1e-5; each train step's gradient, as one vector,
at cosine > 0.9999 with JAX's; the InfoSeg driver's loss history within
1e-4 relative of JAX's (one batch an epoch, so the shuffles, whose
streams differ, cannot matter).
"""

import glob
import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import onet_tpu.core.checkpoint as JCk
from onet_tpu.models import iic as JI
from onet_tpu.models import infoseg as JF

from onet_tpu_torch.models import iic as TI
from onet_tpu_torch.models import infoseg as TF
from onet_tpu_torch.models.unet import tree_leaves, tree_map
from onet_tpu_torch.train import baseline as TB
from onet_tpu_torch.train import iic as TTI
from onet_tpu_torch.train import infoseg as TTF
from onet_tpu_torch.train import steps as TSteps

BASE, N, H, W = 8, 3, 30, 34


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _frames(seed=0, n=N, h=H, w=W):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, h, w, 1)).astype(np.float32)


def _meta(meta):
    return TI.PairMeta(*[torch.tensor(np.asarray(m)) for m in meta])


def _jax_gain(key, n, gain=0.2):
    """The gains iic_pair_transform draws from ``key`` (its fifth split)."""
    kg = jax.random.split(key, 5)[4]
    return np.asarray(1.0 + gain * (2.0 * jax.random.uniform(
        kg, (n, 1, 1, 1)) - 1.0)).reshape(n)


def _iic_pair_loss_jax(p, s, x, x2, meta):
    """The JAX train step's objective (onet_tpu/train/iic.py)."""
    out, ns = JI.iic_forward(p, s, jnp.concatenate([x, x2]), train=True)
    n = x.shape[0]
    o1 = JI.IICOut(out.probs[:n], out.probs_aux[:n])
    p2, mask = JI.iic_undo_geometry(out.probs[n:], meta)
    p2a, _ = JI.iic_undo_geometry(out.probs_aux[n:], meta)
    return JI.compute_iic_loss(o1, JI.IICOut(p2, p2a), mask), ns


def _infoseg_loss_jax(p, s, x):
    out, ns = JF.infoseg_forward(p, s, x, train=True)
    return JF.compute_infoseg_loss(out), ns


@pytest.fixture(scope="module")
def case():
    """The port's weights, frames, JAX's view draws and JAX's outputs:
    the IIC and InfoSeg objectives' values and gradients, their eval
    forwards, and the IIC loss pieces on the step's own maps; the
    programs compile in threads at once."""
    from concurrent.futures import ThreadPoolExecutor

    gen = torch.Generator().manual_seed(3)
    ip, is_ = TI.iic_init(gen, 1, 2, k_aux=6, base=BASE, device="cpu")
    fp, fs = TF.infoseg_init(gen, 1, 2, base=BASE, device="cpu")
    x = _frames()
    key = jax.random.key(21)
    x2, meta = jax.jit(JI.iic_pair_transform)(key, x)
    x2, meta = np.asarray(x2), _np(meta)

    def iic_grad(p, s, x, x2, meta):
        (loss, ns), g = jax.value_and_grad(_iic_pair_loss_jax, has_aux=True)(
            p, s, x, x2, meta)
        out, _ = JI.iic_forward(p, s, x, train=False)
        return loss, g, ns, out.probs, out.probs_aux

    def info_grad(p, s, x):
        (loss, ns), g = jax.value_and_grad(_infoseg_loss_jax, has_aux=True)(
            p, s, x)
        out, _ = JF.infoseg_forward(p, s, x, train=False)
        return loss, g, ns, out

    jobs = [(iic_grad, (_to_jax(ip), _to_jax(is_), x, x2,
                        jax.tree.map(jnp.asarray, meta))),
            (info_grad, (_to_jax(fp), _to_jax(fs), x))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(
            lambda j: jax.jit(j[0]).lower(*j[1]).compile(), jobs))
    iic_out, info_out = (_np(exe(*args)) for exe, (_, args) in
                         zip(compiled, jobs))
    return dict(x=x, x2=x2, meta=meta, gain=_jax_gain(key, N), iic=(ip, is_),
                infoseg=(fp, fs), iic_out=iic_out, info_out=info_out)


def _close(got, want, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol, rtol=rtol)


def _cos(got_tree, want_tree):
    a = np.concatenate([t.detach().numpy().ravel()
                        for t in tree_leaves(got_tree)])
    b = np.concatenate([np.ravel(t) for t in jax.tree.leaves(want_tree)])
    assert a.shape == b.shape
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _capture_grads(monkeypatch):
    """Replace the baselines' Adam with a recorder of the gradients it is
    given (the parameters do not move)."""
    got = {}

    def capture(grads, opt_state, lr):
        got["grads"] = grads
        return tree_map(torch.zeros_like, grads), opt_state

    monkeypatch.setattr(TSteps, "adam_update", capture)
    return got


@pytest.mark.parametrize("seed,shape,max_shift", [
    (1, (3, 30, 34, 1), 2), (2, (4, 16, 16, 3), 3), (3, (2, 9, 7, 1), 1)])
def test_iic_pair_from_is_jax_pair_transform(seed, shape, max_shift):
    """The view on JAX's draws, bit for bit: flips (W, then H), the
    zero-fill shift, the gain and the clip."""
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    key = jax.random.key(seed)
    want, meta = jax.jit(JI.iic_pair_transform, static_argnames=(
        "max_shift",))(key, jnp.asarray(x), max_shift=max_shift)
    got = TI.iic_pair_from(torch.tensor(x), _meta(meta),
                           torch.tensor(_jax_gain(key, shape[0])))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_iic_undo_geometry_matches_jax(case):
    """The inverse on the transformed view's maps and the validity mask,
    bit for bit; g^-1(g(q)) == q wherever the mask is 1."""
    q = np.random.default_rng(4).uniform(0, 1, (N, H, W, 6)).astype(
        np.float32)
    want_p, want_m = jax.jit(JI.iic_undo_geometry)(jnp.asarray(q),
                                                   case["meta"])
    got_p, got_m = TI.iic_undo_geometry(torch.tensor(q),
                                        _meta(case["meta"]))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    meta = _meta(case["meta"])
    view = TI.iic_pair_from(torch.tensor(q), meta, torch.ones(N))
    back, m = TI.iic_undo_geometry(view, meta)
    assert torch.equal(back * m, torch.tensor(q) * m)
    assert 0.5 < float(m.mean()) < 1.0


def test_iic_joint_mi_and_loss_match_jax(case):
    """iic_joint (the (2r+1)^2 roll window), mutual_information and
    compute_iic_loss on the eval forward's maps, with the JAX view's mask,
    at radius 1 and 2."""
    probs, aux = case["iic_out"][3], case["iic_out"][4]

    @jax.jit
    def jax_side(probs, aux, meta):
        p2, mask = JI.iic_undo_geometry(probs[::-1], meta)
        joints = [JI.iic_joint(probs, p2, mask, radius=r) for r in (1, 2)]
        loss = JI.compute_iic_loss(JI.IICOut(probs, aux),
                                   JI.IICOut(p2, aux[::-1]), mask)
        return (p2, mask, joints, [JI.mutual_information(j) for j in joints],
                loss)

    p2, mask, joints, mis, loss = _np(jax_side(probs, aux, case["meta"]))
    tp1, tp2, tmask = map(torch.tensor, (probs, p2, mask))
    for r, want, mi in zip((1, 2), joints, mis):
        got = TI.iic_joint(tp1, tp2, tmask, radius=r)
        _close(got, want, atol=1e-7, rtol=1e-5)
        assert abs(float(TI.mutual_information(got)) - float(mi)) < 1e-5
    got = TI.compute_iic_loss(
        TI.IICOut(tp1, torch.tensor(aux)),
        TI.IICOut(tp2, torch.tensor(aux[::-1].copy())), tmask)
    assert abs(float(got) - float(loss)) < 1e-5


def test_iic_forward_matches_jax(case):
    p, s = case["iic"]
    with torch.no_grad():
        out, ns = TI.iic_forward(p, s, torch.tensor(case["x"]))
    _close(out.probs, case["iic_out"][3])
    _close(out.probs_aux, case["iic_out"][4])
    assert ns.keys() == s.keys()
    assert torch.equal(TI.get_label(out.probs),
                       torch.argmax(out.probs, -1).to(torch.int32))


def test_iic_train_step_matches_jax(case, monkeypatch):
    """make_iic_train_step on JAX's views (the step's draw patched to
    return them): the [2N] forward, the inverse, the joint and the loss;
    its value, gradient and new BN statistics against JAX's."""
    got = _capture_grads(monkeypatch)
    monkeypatch.setattr(
        TTI, "iic_pair_transform",
        lambda gen, x, **kw: (torch.tensor(case["x2"]), _meta(case["meta"])))
    p, s = case["iic"]
    step = TTI.make_iic_train_step(TTI.IICConfig())
    _, ns, _, loss = step(p, s, None, torch.tensor(case["x"]), None, 1e-4)
    jloss, jg, jns = case["iic_out"][:3]
    assert abs(float(loss) - float(jloss)) < 1e-5
    assert _cos(got["grads"], jg) > 0.9999
    for k in ns:
        for a, b in zip(tree_leaves(ns[k]), jax.tree.leaves(jns[k])):
            _close(a, b, atol=1e-5, rtol=1e-5)


def test_infoseg_forward_loss_and_step_match_jax(case, monkeypatch):
    p, s = case["infoseg"]
    jloss, jg, jns, jout = case["info_out"]
    with torch.no_grad():
        out, _ = TF.infoseg_forward(p, s, torch.tensor(case["x"]))
    for k in ("logits", "scores", "probs", "feats", "glob"):
        _close(getattr(out, k), getattr(jout, k))
    got = _capture_grads(monkeypatch)
    _, ns, _, loss = TTF.make_infoseg_train_step()(
        p, s, None, torch.tensor(case["x"]), 1e-4)
    assert abs(float(loss) - float(jloss)) < 1e-5
    assert _cos(got["grads"], jg) > 0.9999
    for k in ns:
        for a, b in zip(tree_leaves(ns[k]), jax.tree.leaves(jns[k])):
            _close(a, b, atol=1e-5, rtol=1e-5)
    # the critic's own-image slice of sim and the batch-1 form (no
    # negatives)
    one = TF.InfoSegOut(*(t[:1] for t in out))
    want = JF.compute_infoseg_loss(JF.InfoSegOut(
        *(jnp.asarray(np.asarray(t)[:1]) for t in jout)))
    assert abs(float(TF.compute_infoseg_loss(one)) - float(want)) < 1e-5


def test_iic_pair_transform_draws():
    """The port's own draws: one generator seed, one view; flips are
    booleans, shifts in [-s, s], gains in [1 - g, 1 + g], and the view is
    iic_pair_from of those draws."""
    x = torch.tensor(_frames(5, n=64, h=8, w=8))
    a, ma = TI.iic_pair_transform(torch.Generator().manual_seed(1), x,
                                  max_shift=2)
    b, mb = TI.iic_pair_transform(torch.Generator().manual_seed(1), x,
                                  max_shift=2)
    assert torch.equal(a, b) and all(torch.equal(u, v)
                                     for u, v in zip(ma, mb))
    assert ma.flip_h.dtype == torch.bool and 0 < int(ma.flip_h.sum()) < 64
    assert int(ma.dy.min()) == -2 and int(ma.dy.max()) == 2
    g = torch.Generator().manual_seed(1)
    for draw in (torch.rand, torch.rand):
        draw((64,), generator=g)
    for _ in range(2):
        torch.randint(-2, 3, (64,), generator=g)
    gain = 1.0 + 0.2 * (2.0 * torch.rand((64,), generator=g) - 1.0)
    assert torch.equal(a, TI.iic_pair_from(x, ma, gain))
    assert float(gain.min()) >= 0.8 and float(gain.max()) <= 1.2


def _toy(n, seed):
    """Frames with one bright square each, their masks the labels."""
    rng = np.random.default_rng(seed)
    imgs = rng.rayleigh(0.15, size=(n, 16, 16)).astype(np.float32)
    labels = np.zeros((n, 16, 16), np.int32)
    for i in range(n):
        y, x = rng.integers(2, 10, 2)
        imgs[i, y:y + 4, x:x + 4] += 1.0
        labels[i, y:y + 4, x:x + 4] = 1
    imgs = imgs / imgs.max(axis=(1, 2), keepdims=True)
    return imgs[..., None], labels


def test_infoseg_driver_matches_jax(case, tmp_path, monkeypatch):
    """train/infoseg.py's train() against the JAX driver on the same
    frames and weights, one batch an epoch: the loss history, the eval
    epochs and metrics, and the final checkpoint bit-equal across the
    packages' readers."""
    from onet_tpu.data.arrays import ArrayDataset as JArrayDataset
    from onet_tpu.train import infoseg as JTF

    from onet_tpu_torch.core.checkpoint import load_checkpoint
    from onet_tpu_torch.data.arrays import ArrayDataset

    imgs, labels = _toy(4, 7)
    p0, s0 = TF.infoseg_init(torch.Generator().manual_seed(8), 1, 2,
                             base=BASE, device="cpu")
    cfg = dict(model_name="m", epoch_nums=3, batch_sz=4, eval_every=2,
               base_channels=BASE)
    monkeypatch.setattr(JTF, "infoseg_init",
                        lambda *a, **kw: (_to_jax(p0), _to_jax(s0)))
    jds = JArrayDataset({"imgs": jnp.asarray(imgs),
                         "labels": jnp.asarray(labels)})
    _, _, jh = JTF.train(JTF.InfoSegConfig(out_root=str(tmp_path / "j"),
                                           **cfg), datasets=(jds, jds),
                         log=False)
    monkeypatch.setattr(TTF, "infoseg_init", lambda *a, **kw: (
        tree_map(torch.clone, p0), tree_map(torch.clone, s0)))
    tds = ArrayDataset({"imgs": torch.tensor(imgs),
                        "labels": torch.tensor(labels)})
    tp, ts, th = TTF.train(TTF.InfoSegConfig(out_root=str(tmp_path / "t"),
                                             **cfg), datasets=(tds, tds),
                           log=False, device="cpu")
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert sorted(th["eval"]) == sorted(jh["eval"]) == [0, 2]
    for e in jh["eval"]:
        for k, v in jh["eval"][e].items():
            assert abs(th["eval"][e][k] - v) <= 1e-2, (e, k)
    saved = glob.glob(str(tmp_path / "t" / "m_*_epoch_2.npz"))
    assert len(saved) == 1
    jp, js, je = JCk.load_checkpoint(saved[0], _to_jax(p0), _to_jax(s0))
    assert je == 2
    for a, b in zip(tree_leaves([tp, ts]), jax.tree.leaves((jp, js))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    jsaved = glob.glob(str(tmp_path / "j" / "m_*_epoch_2.npz"))
    assert len(jsaved) == 1
    jp2, js2, _ = JCk.load_checkpoint(jsaved[0], _to_jax(p0), _to_jax(s0))
    p2, s2, e2 = load_checkpoint(jsaved[0], p0, s0)
    assert e2 == 2
    for a, b in zip(tree_leaves([p2, s2]), jax.tree.leaves((jp2, js2))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_iic_driver_logs_evaluates_and_saves(tmp_path, capsys):
    """train/iic.py's train() through the shared loop: shuffled drop-last
    batches (5 frames, batch 2: two steps an epoch), eval at epochs 0 and
    2 and the last, the reference's epoch lines printed and in the run
    log, one final checkpoint with the trained state."""
    from onet_tpu_torch.core.checkpoint import load_checkpoint
    from onet_tpu_torch.data.arrays import ArrayDataset

    imgs, labels = _toy(5, 9)
    ds = ArrayDataset({"imgs": torch.tensor(imgs),
                       "labels": torch.tensor(labels)})
    cfg = TTI.IICConfig(model_name="iic_t", epoch_nums=4, batch_sz=2,
                        eval_every=2, base_channels=BASE,
                        out_root=str(tmp_path))
    steps = []
    real = TTI.make_iic_train_step

    def counted(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            steps.append(args[3].shape[0])
            return step(*args)
        return run

    TTI.make_iic_train_step = counted
    try:
        p, s, hist = TTI.train(cfg, datasets=(ds, ds), device="cpu")
    finally:
        TTI.make_iic_train_step = real
    assert steps == [2] * 8
    assert len(hist["loss"]) == 4 and all(np.isfinite(hist["loss"]))
    assert sorted(hist["eval"]) == [0, 2, 3]
    assert set(hist["eval"][3]) == {"acc", "miou", "dr", "far", "tiou"}
    out = capsys.readouterr().out
    assert out.count("iic_t===Epoch:") == 3 and "[iic] checkpoint:" in out
    logs = glob.glob(str(tmp_path / "iic_t_*.log"))
    assert logs and "iic_t===Epoch: 0003" in open(logs[0]).read()
    saved = glob.glob(str(tmp_path / "iic_t_*_epoch_3.npz"))
    assert len(saved) == 1
    p2, s2, e2 = load_checkpoint(saved[0], p, s)
    assert e2 == 3 and all(torch.equal(a, b) for a, b in
                           zip(tree_leaves([p2, s2]), tree_leaves([p, s])))


def test_baseline_loop_drains_on_sigterm(tmp_path):
    """A SIGTERM during the first epoch: the step in flight finishes, the
    state is checkpointed with that epoch recorded as not done, the loop
    returns and the previous handler is back."""
    from onet_tpu_torch.core.checkpoint import load_checkpoint
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.train.optim import adam_init

    imgs, labels = _toy(4, 3)
    ds = ArrayDataset({"imgs": torch.tensor(imgs),
                       "labels": torch.tensor(labels)})
    p, s = TF.infoseg_init(torch.Generator().manual_seed(1), 1, 2,
                           base=BASE, device="cpu")
    cfg = TTF.InfoSegConfig(model_name="m", epoch_nums=3, batch_sz=2,
                            base_channels=BASE, out_root=str(tmp_path))
    real = TTF.make_infoseg_train_step()
    calls = []

    def step(*args):
        calls.append(1)
        os.kill(os.getpid(), signal.SIGTERM)
        return real(*args)

    before = signal.getsignal(signal.SIGTERM)
    p, s, hist = TB.baseline_training_loop(
        cfg, p, s, adam_init(p), step, TTF.make_infoseg_eval_step(), ds,
        ds, 5, log=False, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    assert calls == [1] and hist == {"loss": [], "eval": {},
                                     "preempted": 0}
    saved = glob.glob(str(tmp_path / "m_preempt0_*.npz"))
    assert len(saved) == 1
    p2, _, epoch = load_checkpoint(saved[0], p, s)
    assert epoch == -1 and all(torch.equal(a, b) for a, b in
                               zip(tree_leaves(p2), tree_leaves(p)))
