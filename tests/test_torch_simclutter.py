"""The port's simclutter driver (onet_tpu_torch/train/simclutter.py)
against the JAX package's, on the CPU, in fp32.

Setup: base 8, 32x32 frames (JAX-generated: 3 SNR levels x 4 frames at
64x64 cropped to 32, split 10/2 by the JAX package's own
``simclutter_datasets``), the same datasets passed to both drivers, and
the same initial weights (the port's init is patched to return the JAX
init's weights through ``core/bridge.from_jax_numpy``). ``batch_sz`` is
the training set's size, so each epoch is one batch and the shuffle, whose
streams differ between the packages, cannot matter.

Tolerances: the loss history within 1e-4 relative (three fp32 steps of the
same net, summed in other orders), eval metrics within 1e-2 absolute (a
pixel near the decision boundary may flip). A resumed run reproduces the
uninterrupted one exactly: the same file bits, Adam state and epoch
generator.
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

from onet_tpu.data.arrays import ArrayDataset as JArrayDataset
from onet_tpu.data.simclutter import simclutter_datasets as j_datasets
from onet_tpu.models import onet as JO
from onet_tpu.sim.rayleigh import rayleigh_frames as j_rayleigh_frames
from onet_tpu.train import simclutter as JS

from onet_tpu_torch.core.bridge import from_jax_numpy, load_onet_npz
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.models.unet import tree_leaves
from onet_tpu_torch.train import simclutter as TS

SEED = 1981
# JAX's init, jitted: the eager one compiles op by op for ~20 s on the CPU;
# the JAX driver is given this one too, so both packages start from it
J_INIT = jax.jit(JO.onet_init, static_argnums=(1,),
                 static_argnames=("weight_share", "dtype", "base"))
CFG = dict(model_name="m", epoch_nums=3, input_sz=32, base_channels=8,
           eval_every=1, save_epochs=(), seed=SEED)


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


@pytest.fixture(scope="module")
def jax_data():
    key = jax.random.key(7)
    imgs, labels, psnr = [], [], []
    for lvl in range(3):
        f, m = j_rayleigh_frames(jax.random.fold_in(key, lvl), float(lvl),
                                 n_frames=4, frame_size=64, crop=32)
        imgs.append(f)
        labels.append(m)
        psnr.append(jnp.full((4,), lvl, jnp.int32))
    src = JArrayDataset({"imgs": jnp.concatenate(imgs)[..., None],
                         "labels": jnp.concatenate(labels),
                         "psnr": jnp.concatenate(psnr)})
    return j_datasets(jax.random.key(8), source=src, crop=32)


def _to_port(ds):
    return ArrayDataset({k: torch.tensor(np.array(v)) for k, v in
                         ds.data.items()})


@pytest.fixture(scope="module")
def jax_init():
    k_model = jax.random.split(jax.random.key(SEED), 3)[1]
    return _np(J_INIT(k_model, 1, base=8))


@pytest.fixture
def port_init(monkeypatch, jax_init):
    def init(gen, in_channels=1, *, weight_share=True, base=64,
             device=None, **kw):
        assert (in_channels, weight_share, base) == (1, True, 8)
        return from_jax_numpy(*jax_init, device=device)

    monkeypatch.setattr(TO, "onet_init", init)


@pytest.fixture(scope="module")
def jax_run(jax_data, tmp_path_factory):
    train_ds, test_ds = jax_data
    cfg = JS.SimclutterConfig(**CFG, batch_sz=len(train_ds),
                              out_root=str(tmp_path_factory.mktemp("jax")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JO, "onet_init", J_INIT)
        _, _, hist = JS.train(cfg, datasets=jax_data, log=False)
    return hist


def _port_train(jax_data, out_root, **kw):
    train_ds, test_ds = (_to_port(d) for d in jax_data)
    cfg = TS.SimclutterConfig(**{**CFG, **kw}, batch_sz=len(train_ds),
                              out_root=str(out_root))
    return TS.train(cfg, datasets=(train_ds, test_ds), log=False,
                    device="cpu")


@pytest.fixture(scope="module")
def port_run(jax_data, jax_init, tmp_path_factory):
    """The port's uninterrupted run from JAX's init, shared by the tests
    that hold it to JAX's and to a resumed run: (params, history, its
    output directory)."""
    out = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "onet_init", lambda gen, in_channels=1, *, device=None,
                   **kw: from_jax_numpy(*jax_init, device=device))
        params, _, hist = _port_train(jax_data, out)
    return params, hist, out


def test_driver_matches_jax(jax_run, port_run):
    params, hist, out = port_run
    np.testing.assert_allclose(hist["loss"], jax_run["loss"], rtol=1e-4)
    assert sorted(hist["eval"]) == sorted(jax_run["eval"]) == [0, 1, 2]
    for e, want in jax_run["eval"].items():
        got = hist["eval"][e]
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - float(want[k])) <= 1e-2, (e, k)
    # the final milestone, in the JAX package's format
    saved = glob.glob(os.path.join(str(out), "m_epoch_2_*.npz"))
    assert len(saved) == 1
    p2, _, epoch = load_onet_npz(saved[0], device="cpu")
    assert epoch == 2
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p2), tree_leaves(params)))


def test_resume_continues_the_epoch_count(jax_data, port_init, port_run,
                                          tmp_path):
    full = port_run[1]
    _, _, first = _port_train(jax_data, tmp_path / "cut", epoch_nums=2)
    assert len(first["loss"]) == 2
    params, _, rest = _port_train(jax_data, tmp_path / "cut", resume=True)
    assert list(rest["eval"]) == [2] and len(rest["loss"]) == 1
    # the same file bits, Adam state and epoch generator: epoch 2 again
    assert rest["loss"][0] == full["loss"][2]
    assert rest["eval"][2] == full["eval"][2]


def test_sigterm_drains_and_resumes(jax_data, port_init, tmp_path):
    assert threading.current_thread() is threading.main_thread()

    def cb(epoch, loss, metrics):
        if epoch == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    train_ds, test_ds = (_to_port(d) for d in jax_data)
    cfg = TS.SimclutterConfig(**{**CFG, "epoch_nums": 5},
                              batch_sz=len(train_ds) // 2,
                              out_root=str(tmp_path))
    _, _, hist = TS.train(cfg, datasets=(train_ds, test_ds), log=False,
                          progress_cb=cb, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    assert hist["preempted"] == 1 and len(hist["loss"]) == 1
    saved = glob.glob(os.path.join(str(tmp_path), "m_autosave_0_*.npz"))
    assert len(saved) == 1
    with np.load(saved[0]) as z:
        assert int(z["__epoch__"]) == 0
        assert int(z["o:.count"]) == 3     # two steps of epoch 0, one of 1
    _, _, rest = TS.train(
        TS.SimclutterConfig(**{**CFG, "epoch_nums": 2, "resume": True},
                            batch_sz=len(train_ds) // 2,
                            out_root=str(tmp_path)),
        datasets=(train_ds, test_ds), log=False, device="cpu")
    assert list(rest["eval"]) == [1] and "preempted" not in rest


@pytest.mark.parametrize("kw", [
    dict(mesh=True), dict(pipeline_microbatches=2), dict(spatial=True),
    dict(config=TS.SimclutterConfig(arch="convnext"), mesh=True,
         pipeline_microbatches=2),
    dict(config=TS.SimclutterConfig(arch="swin"), mesh=True, spatial=True),
])
def test_unported_options_raise(jax_data, port_init, port_run, tmp_path,
                                kw):
    """The parallel options, once refused as not ported: a mesh of one
    rank (no process group) trains exactly as the plain driver does, and
    the rest are the JAX package's own refusals (ValueError): the
    pipeline or the spatial step without a mesh, either on a backbone
    other than the vanilla U-Net. Many-rank runs:
    tests/test_torch_parallel_drivers.py."""
    from onet_tpu_torch.core.mesh import make_mesh
    if kw.get("mesh"):
        kw = dict(kw, mesh=make_mesh((1,), ("data",)))
    if "config" in kw or "pipeline_microbatches" in kw or "spatial" in kw:
        with pytest.raises(ValueError):
            TS.train(**kw, log=False, device="cpu")
        return
    train_ds, test_ds = (_to_port(d) for d in jax_data)
    cfg = TS.SimclutterConfig(**{**CFG, "epoch_nums": 1},
                              batch_sz=len(train_ds), out_root=str(tmp_path))
    _, _, hist = TS.train(cfg, datasets=(train_ds, test_ds), log=False,
                          device="cpu", **kw)
    full = port_run[1]
    assert hist["loss"][0] == full["loss"][0]
    assert hist["eval"][0] == full["eval"][0]


@pytest.mark.parametrize("kw", [dict(loss="rsn"), dict(aug=True)])
def test_loss_and_aug_options_train(jax_data, port_init, tmp_path, kw):
    _, _, hist = _port_train(jax_data, tmp_path, epoch_nums=1, **kw)
    assert np.isfinite(hist["loss"][0])
