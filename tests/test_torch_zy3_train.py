"""The port's ZY-3 driver (onet_tpu_torch/train/zy3.py), its per-image
eval, its supervised step, determine_fg_mark and the pair-packed path at
in_channels=3, against the JAX package's, on the CPU, in fp32.

Setup: base 8, 32x32 RGB scenes made by the JAX package's own
``synthesize_zy3`` (8 train, 5 test), the same datasets passed to both
drivers, and the same initial weights (the port's init is patched to
return the JAX init's weights through ``core/bridge.from_jax_numpy``).
``batch_sz`` is the training set's size, so each epoch is one batch and
the shuffle, whose streams differ between the packages, cannot matter;
``aug`` is off for the same reason (the augmentation is held to JAX's on
JAX's own draws in tests/test_torch_zy3.py).

Tolerances: the loss history within 1e-4 relative (three fp32 steps of the
same net, summed in other orders); each epoch's eval metrics and test loss
within 1e-2 absolute (a pixel near the decision boundary may flip). The
per-image eval: each image's metrics within one pixel's share of a frame
(1/1024), the Hungarian choice equal. The supervised step's first loss
within 1e-4 relative. The pair-packed forward at in_channels=3 (base 64,
16x16, batch 1): S within 1e-4, the loss within 1e-4 relative, as
tests/test_torch_train_wp.py holds the one-channel path.
"""

import glob
import os
import signal
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.data import zy3 as JZ
from onet_tpu.data.arrays import ArrayDataset as JArrayDataset
from onet_tpu.models import onet as JO
from onet_tpu.train import zy3 as JT
import onet_tpu.ops.pallas_conv as PC

from onet_tpu_torch.core.bridge import from_jax_numpy, load_onet_npz
from onet_tpu_torch.core.policy import DEFAULT
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.models.unet import tree_leaves
from onet_tpu_torch.train import zy3 as TT
from onet_tpu_torch.train.optim import adam_init

SEED = 1981
PIXEL = 1.0 / (32 * 32)
J_INIT = jax.jit(JO.onet_init, static_argnums=(1,),
                 static_argnames=("weight_share", "dtype", "base"))
CFG = dict(model_name="m", epoch_nums=3, input_sz=32, base_channels=8,
           save_epochs=(), seed=SEED, aug=False)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where several test
    processes share the cores, a parallel region waits for threads that
    are not scheduled and a millisecond op takes tens of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _to_port(ds):
    return ArrayDataset({k: torch.tensor(np.array(v)) for k, v in
                         ds.data.items()})


@pytest.fixture(scope="module")
def jax_data():
    """(train, test) JAX datasets: 8 and 5 scenes of 32x32 (jitted: the
    eager vmap compiles op by op)."""
    make = jax.jit(lambda k, n: JZ.synthesize_zy3(k, n=n, size=32)[0].data,
                   static_argnums=(1,))
    return (JArrayDataset(make(jax.random.key(3), 8)),
            JArrayDataset(make(jax.random.key(4), 5)))


@pytest.fixture(scope="module")
def jax_init():
    return _np(J_INIT(jax.random.key(SEED), 3, base=8))


@pytest.fixture
def port_init(monkeypatch, jax_init):
    def init(gen, in_channels=1, *, weight_share=True, base=64,
             device=None, **kw):
        assert (in_channels, weight_share, base) == (3, True, 8)
        return from_jax_numpy(*jax_init, device=device)

    monkeypatch.setattr(TO, "onet_init", init)


@pytest.fixture(scope="module")
def jax_run(jax_data, jax_init, tmp_path_factory):
    train_ds, test_ds = jax_data
    out = tmp_path_factory.mktemp("jax")
    cfg = JT.Zy3Config(**CFG, batch_sz=len(train_ds), out_root=str(out))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JO, "onet_init", lambda *a, **kw: jax_init)
        _, _, hist = JT.train(cfg, train_ds, test_ds, log=False)
    return hist, glob.glob(os.path.join(str(out), "m_epoch2_*.npz"))


def _port_train(jax_data, out_root, **kw):
    train_ds, test_ds = (_to_port(d) for d in jax_data)
    cfg = TT.Zy3Config(**{**CFG, **kw}, batch_sz=len(train_ds),
                       out_root=str(out_root))
    return TT.train(cfg, train_ds, test_ds, log=False, device="cpu")


def _close_history(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert sorted(got["eval"]) == sorted(want["eval"])
    for e, w in want["eval"].items():
        g = got["eval"][e]
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - float(w[k])) <= 1e-2, (e, k, g[k], w[k])


@pytest.fixture(scope="module")
def port_run(jax_data, jax_init, tmp_path_factory):
    """The port's uninterrupted run from JAX's init, shared by the tests
    that hold it to JAX's and to a restarted run: (params, history, its
    output directory)."""
    out = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "onet_init", lambda gen, in_channels=1, *, device=None,
                   **kw: from_jax_numpy(*jax_init, device=device))
        params, _, hist = _port_train(jax_data, out)
    return params, hist, out


def test_driver_matches_jax(jax_run, port_run):
    want, _ = jax_run
    params, hist, out = port_run
    assert sorted(hist["eval"]) == [0, 1, 2]
    _close_history(hist, want)
    # the final milestone, in the JAX package's format and file name
    saved = glob.glob(os.path.join(str(out), "m_epoch2_*.npz"))
    assert len(saved) == 1
    p2, _, epoch = load_onet_npz(saved[0], device="cpu")
    assert epoch == 2
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p2), tree_leaves(params)))


def test_restart_from_continues_the_epoch_count(jax_data, jax_run,
                                                port_init, port_run,
                                                tmp_path):
    _, jax_files = jax_run
    full = port_run[1]
    _, _, first = _port_train(jax_data, tmp_path / "cut", epoch_nums=2)
    assert len(first["loss"]) == 2
    saved = glob.glob(os.path.join(str(tmp_path / "cut"), "m_epoch1_*.npz"))
    assert len(saved) == 1
    _, _, rest = _port_train(jax_data, tmp_path / "cut",
                             restart_from=saved[0])
    assert list(rest["eval"]) == [2] and len(rest["loss"]) == 1
    # the same file bits and Adam state: epoch 2 again, exactly
    assert rest["loss"][0] == full["loss"][2]
    assert rest["eval"][2] == full["eval"][2]
    # the JAX package's own milestone continues here too, at epoch 3
    assert len(jax_files) == 1
    _, _, more = _port_train(jax_data, tmp_path / "from_jax", epoch_nums=4,
                             restart_from=jax_files[0])
    assert list(more["eval"]) == [3] and np.isfinite(more["loss"][0])


def test_sigterm_drains_and_restarts(jax_data, port_init, tmp_path):
    assert threading.current_thread() is threading.main_thread()

    def cb(epoch, loss, metrics):
        if epoch == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    train_ds, test_ds = (_to_port(d) for d in jax_data)
    cfg = TT.Zy3Config(**{**CFG, "epoch_nums": 5},
                       batch_sz=len(train_ds) // 2, out_root=str(tmp_path))
    _, _, hist = TT.train(cfg, train_ds, test_ds, log=False, progress_cb=cb,
                          device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    assert hist["preempted"] == 1 and len(hist["loss"]) == 1
    saved = glob.glob(os.path.join(str(tmp_path), "m_preempt0_*.npz"))
    assert len(saved) == 1
    with np.load(saved[0]) as z:
        assert int(z["__epoch__"]) == 0
        assert int(z["o:.count"]) == 3     # two steps of epoch 0, one of 1
    _, _, rest = TT.train(
        TT.Zy3Config(**{**CFG, "epoch_nums": 2, "restart_from": saved[0]},
                     batch_sz=len(train_ds) // 2, out_root=str(tmp_path)),
        train_ds, test_ds, log=False, device="cpu")
    assert list(rest["eval"]) == [1] and "preempted" not in rest


@pytest.mark.parametrize("kw", [dict(loss="rsn"), dict(aug=True)])
def test_loss_and_aug_options_train(jax_data, port_init, tmp_path, kw):
    _, _, hist = _port_train(jax_data, tmp_path, epoch_nums=1, **kw)
    assert np.isfinite(hist["loss"][0])


def _one_rank_mesh():
    from onet_tpu_torch.core.mesh import make_mesh
    return make_mesh((1,), ("data",))


def _mesh_driver_epoch(jax_data, port_run, tmp_path):
    """train(mesh=) on a mesh of one rank: the plain driver's first epoch,
    bit for bit."""
    train_ds, test_ds = (_to_port(d) for d in jax_data)
    cfg = TT.Zy3Config(**{**CFG, "epoch_nums": 1}, batch_sz=len(train_ds),
                       out_root=str(tmp_path))
    _, _, hist = TT.train(cfg, train_ds, test_ds, mesh=_one_rank_mesh(),
                          log=False, device="cpu")
    assert hist["loss"][0] == port_run[1]["loss"][0]
    assert hist["eval"][0] == port_run[1]["eval"][0]


def _mesh_family_step(name):
    """make_train_step(mesh=, forward=) of another family (ZY-3's driver
    builds it so) on a mesh of one rank: the plain step's loss and
    gradient, bit for bit."""
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.train.steps import make_train_step

    arch = get_arch(name, swin_window=2, swin_embed=12, convnext_embed=16)
    p, s = arch.init(torch.Generator().manual_seed(3), 3, base=64,
                     device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    got = [make_train_step(forward=arch.forward, **kw).loss_and_grads(
        p, s, x) for kw in (dict(), dict(mesh=_one_rank_mesh()))]
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got[0][2]), tree_leaves(got[1][2])))


def _mesh_supervised_step(jax_data, jax_init):
    train_ds, _ = jax_data
    x = torch.tensor(np.array(train_ds["imgs"][:4]))
    lab = torch.tensor(np.array(train_ds["labels"][:4]))
    out = []
    for kw in (dict(), dict(mesh=_one_rank_mesh())):
        tp, ts = from_jax_numpy(*jax_init, device="cpu")
        out.append(TT.make_supervised_train_step(**kw)(
            tp, ts, adam_init(tp), x, lab, 1e-4))
    assert torch.equal(out[0][3], out[1][3])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])))


@pytest.mark.parametrize("call", [
    lambda d, r, t, i: _mesh_driver_epoch(d, r, t),
    lambda d, r, t, i: _mesh_family_step("swin"),
    lambda d, r, t, i: _mesh_family_step("convnext"),
    lambda d, r, t, i: _mesh_supervised_step(d, i),
])
def test_unported_options_raise(jax_data, port_init, port_run, jax_init,
                                tmp_path, call):
    """``mesh``, once refused as not ported, in the driver (vanilla), in the
    step the driver builds for the other families, and in the supervised
    step: the JAX package refuses none of them, and on a mesh of one rank
    (no process group) each gives the plain result bit for bit. Many-rank
    runs: tests/test_torch_parallel_drivers.py."""
    call(jax_data, port_run, tmp_path, jax_init)


def test_zy3_eval_per_image_matches_jax(jax_data, jax_init):
    _, test_ds = jax_data
    x, lab = test_ds["imgs"], test_ds["labels"]
    jm, jloss, jal, jvt, jvd = JT.make_zy3_eval()(*jax_init, x, lab)
    tm, tloss, tal, tvt, tvd = TT.make_zy3_eval()(
        *from_jax_numpy(*jax_init, device="cpu"),
        torch.tensor(np.array(x)), torch.tensor(np.array(lab)))
    assert set(tm) == set(TT.METRICS) <= set(jm)
    for k in TT.METRICS:
        assert tm[k].shape == (5,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=PIXEL, rtol=0)
    # the same keep-or-swap per image: at most a boundary pixel apart
    assert (tal.numpy() != np.asarray(jal)).sum(axis=(1, 2)).max() <= 2
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    np.testing.assert_allclose(tvt.numpy(), np.asarray(jvt), atol=1e-4)
    np.testing.assert_allclose(tvd.numpy(), np.asarray(jvd), atol=1e-4)


def test_supervised_step_first_loss_matches_jax(jax_data, jax_init):
    from onet_tpu.train.optim import adam_init as j_adam_init

    train_ds, _ = jax_data
    x, lab = train_ds["imgs"][:4], train_ds["labels"][:4]
    jp, js = jax.tree.map(lambda a: jnp.array(a, copy=True), jax_init)
    j_step = JT.make_supervised_train_step()
    _, _, _, jl = j_step(jp, js, j_adam_init(jp), x, lab, 1e-4)
    tp, ts = from_jax_numpy(*jax_init, device="cpu")
    step = TT.make_supervised_train_step()
    tp1, _, opt, tl = step(tp, ts, adam_init(tp), torch.tensor(np.array(x)),
                           torch.tensor(np.array(lab)), 1e-4)
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert int(opt["count"]) == 1
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(tp1))


@pytest.mark.parametrize("flip", [False, True])
def test_determine_fg_mark_matches_jax(flip):
    rng = np.random.default_rng(9)
    lab = (rng.random((2, 16, 16)) < 0.3).astype(np.int32)
    pred = np.where(rng.random(lab.shape) < 0.1, 1 - lab, lab)
    if flip:
        pred = 1 - pred
    want = JO.determine_fg_mark(jnp.asarray(pred), jnp.asarray(lab))
    got = TO.determine_fg_mark(torch.tensor(pred), torch.tensor(lab))
    assert got == want == ("down" if flip else "top")


def test_pair_packed_forward_at_three_channels():
    """Base 64, 16x16, batch 1, fp32, train mode: the port's wp path (the
    stacked 6-channel inc.conv1, then the pair-packed kernels' plain
    versions) against JAX's onet_forward(pair_pack=True), jitted, its
    Pallas kernels in interpret mode."""
    tp, ts = TO.onet_init(torch.Generator().manual_seed(0), 3,
                          device="cpu")                     # base 64
    params, state = (jax.tree.map(lambda t: np.array(t.numpy(), copy=True),
                                  t) for t in (tp, ts))
    x = np.random.default_rng(5).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    old = PC.INTERPRET
    PC.INTERPRET = True
    try:
        @jax.jit
        def jf(p, s, xx):
            out, _ = JO.onet_forward(p, s, xx, train=True, pair_pack=True)
            return JO.compute_loss(out), out.S

        jl, js = jf(params, state, jnp.asarray(x))
    finally:
        PC.INTERPRET = old
    out, _ = TO.onet_forward(tp, ts, torch.tensor(x), train=True,
                             pair_pack=True, policy=DEFAULT)
    assert out.Lsum is not None             # the wp head ran
    np.testing.assert_allclose(out.S.numpy(), np.asarray(js), atol=1e-4,
                               rtol=0)
    tl = float(TO.compute_loss(out))
    assert abs(tl - float(jl)) <= 1e-4 * abs(float(jl))
