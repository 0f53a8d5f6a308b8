"""The port's simclutter and ZY-3 drivers on a mesh
(onet_tpu_torch/train/simclutter.py, train/zy3.py), on the CPU in fp32.

One gloo world of 4 spawned CPU processes (tests/torch_parallel_worker.py);
every rank of a case's mesh runs the driver, as a multi-process launch
does. The frames are numpy draws (base 8, 32x32); both packages get the
same datasets and the same initial weights (drawn by the port's init and
patched into both drivers' inits). ``batch_sz`` is the training set's size,
so each epoch is one batch and the shuffle, whose streams differ between
the packages, cannot matter; the test set's 11 frames give one eval batch
of 8, split over the data axis, and a remainder of 3, which runs the plain
eval.

Tolerances, as tests/test_torch_simclutter.py: the loss history within
1e-4 relative, eval metrics within 1e-2 absolute.
"""

import concurrent.futures as cf
import os

import numpy as np
import pytest

from torch_parallel_worker import World

CFG = dict(model_name="m", input_sz=32, base_channels=8, eval_every=1,
           save_epochs=(), seed=1981, batch_sz=8)
D, DS, DST = ("data",), ("data", "space"), ("data", "stage")


def _data(seed, n_train=8, n_test=11, c=1):
    rng = np.random.default_rng(seed)

    def ds(n):
        imgs = rng.uniform(0, 1, (n, 32, 32, c)).astype(np.float32)
        labels = (imgs.mean(-1) > 0.6).astype(np.int32)
        return {"imgs": imgs, "labels": labels,
                "psnr": np.zeros((n,), np.int32)}

    return ds(n_train), ds(n_test)


SIM = _data(7)
ZY3 = _data(8, c=3)


def _port_model(c=1):
    import torch
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import tree_map

    p, s = onet_init(torch.Generator().manual_seed(5), c, base=8,
                     device="cpu")
    return tuple(tree_map(lambda t: t.numpy().copy(), t) for t in (p, s))


def _j_sim(params, state, data, cfg):
    """The JAX package's simclutter driver on these datasets and weights."""
    import jax.numpy as jnp
    from onet_tpu.data.arrays import ArrayDataset
    from onet_tpu.models import onet as JO
    from onet_tpu.train import simclutter as JS

    JO.onet_init = lambda *a, **kw: (params, state)
    ds = tuple(ArrayDataset({k: jnp.asarray(v) for k, v in d.items()})
               for d in data)
    _, _, hist = JS.train(JS.SimclutterConfig(**cfg), datasets=ds,
                          log=False)
    return {"loss": [float(v) for v in hist["loss"]],
            "eval": {e: {k: float(v) for k, v in m.items()}
                     for e, m in hist["eval"].items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def model():
    return _port_model()


@pytest.fixture(scope="module")
def jax_sim(model, tmp_path_factory):
    """The JAX driver's two epochs, run in a spawned process from the
    start (its compiles overlap the port's runs)."""
    import multiprocessing as mp
    cfg = dict(CFG, epoch_nums=2,
               out_root=str(tmp_path_factory.mktemp("jax")))
    ex = cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    fut = ex.submit(_j_sim, *model, SIM, cfg)
    yield fut
    ex.shutdown(cancel_futures=True)


@pytest.fixture(scope="module", autouse=True)
def _jax_first(jax_sim):
    """Start the JAX driver before the first test; the tests that read it
    come last."""


def _close(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert sorted(got["eval"]) == sorted(want["eval"])
    for e, w in want["eval"].items():
        for k in w:
            assert abs(got["eval"][e][k] - w[k]) <= 1e-2, (e, k)


def _sim(world, tmp_path, shape, names, model, *, ranks=None, **kw):
    cfg = dict(CFG, epoch_nums=kw.pop("epoch_nums", 2),
               out_root=str(tmp_path), **kw.pop("cfg", {}))
    n = int(np.prod(shape))
    out = world.run("sim", shape=shape, names=names,
                    ranks=ranks or list(range(n)), data=SIM, cfg=cfg,
                    params=model[0], state=model[1], **kw)
    got = [o for o in out if o is not None]
    assert len(got) == n
    assert len({o["digest"] for o in got}) == 1
    assert all(o["hist"] == got[0]["hist"] for o in got)
    return got[0]


def test_resume_under_another_world_size(world, model, tmp_path):
    """Epoch 0 on data 2 with an autosave, then resume=True on data 4 from
    the first rank's checkpoint: epoch 1 as the uninterrupted data-2 run
    has it."""
    full = _sim(world, tmp_path / "full", (2,), D, model)
    _sim(world, tmp_path / "cut", (2,), D, model, epoch_nums=1,
         cfg=dict(autosave_every=1))
    rest = _sim(world, tmp_path / "cut", (4,), D, model,
                cfg=dict(resume=True))
    assert list(rest["hist"]["eval"]) == [1]
    np.testing.assert_allclose(rest["hist"]["loss"], full["hist"]["loss"][1:],
                               rtol=1e-5)


def test_sigterm_on_one_rank_stops_all(world, model, tmp_path):
    """SIGTERM on rank 1 after epoch 0: every rank stops at the same step
    of epoch 1 (the flag is all-reduced with MAX), and the first rank
    alone writes the drain checkpoint."""
    out = world.run("sim", shape=(2,), names=D, ranks=[0, 1], data=SIM,
                    cfg=dict(CFG, epoch_nums=4, out_root=str(tmp_path)),
                    params=model[0], state=model[1], term_rank=1)
    for o in out[:2]:
        assert o["hist"]["preempted"] == 1 and len(o["hist"]["loss"]) == 1
    assert out[0]["digest"] == out[1]["digest"]
    saved = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(saved) == 1 and saved[0].startswith("m_autosave_0_")


def test_sigterm_agreement_is_read_one_poll_late(world):
    """The MAX all-reduce of a step's flag runs while the next step does:
    a SIGTERM on rank 2 after the first poll reaches every rank at the
    third poll, the same one everywhere, and stays set."""
    out = world.run("preempt", shape=(4,), names=D, ranks=[0, 1, 2, 3],
                    term_rank=2)
    assert out == [[False, False, True, True, True]] * 4


def test_zy3_data_parallel_matches_plain(world, tmp_path):
    """The ZY-3 driver on data 2 against the plain driver (two epochs of
    the augmented, cosine-scheduled workload on RGB frames)."""
    import torch
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.models import onet as TO
    from onet_tpu_torch.train import zy3 as TZ
    from torch_parallel_worker import tree_t

    p, s = _port_model(3)
    cfg = dict(model_name="m", epoch_nums=2, input_sz=32, base_channels=8,
               save_epochs=(), seed=1981, batch_sz=8, aug=False)
    out = world.run("zy3", shape=(2,), names=D, ranks=[0, 1], data=ZY3,
                    cfg=dict(cfg, out_root=str(tmp_path / "mesh")),
                    params=p, state=s)
    assert out[0]["digest"] == out[1]["digest"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "onet_init", lambda *a, **kw: (tree_t(p), tree_t(s)))
        ds = [ArrayDataset({k: torch.tensor(v) for k, v in d.items()})
              for d in ZY3]
        _, _, want = TZ.train(TZ.Zy3Config(
            **cfg, out_root=str(tmp_path / "plain")), *ds, log=False,
            device="cpu")
    _close(out[0]["hist"], want)


def test_supervised_step_data_parallel(world):
    """make_supervised_train_step(mesh=) on data 2: the plain step's loss,
    BatchNorm state and update on the global batch."""
    p, s = _port_model(3)
    x, lab = ZY3[0]["imgs"][:4], ZY3[0]["labels"][:4]
    kw = dict(x=x, labels=lab, params=p, state=s, lr=1e-4)
    ref = world.run("supervised", shape=(), names=D, ranks=[0], **kw)[0]
    out = world.run("supervised", shape=(2,), names=D, ranks=[0, 1], **kw)
    assert out[0]["digest"] == out[1]["digest"]
    np.testing.assert_allclose(out[0]["loss"], ref["loss"], rtol=1e-5)
    for got, want in zip(out[0]["bn"], ref["bn"]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
    u1 = np.concatenate([np.ravel(a - q) for a, q in
                         zip(ref["params"], _leaves(p))])
    u2 = np.concatenate([np.ravel(a - q) for a, q in
                         zip(out[0]["params"], _leaves(p))])
    assert np.mean(np.sign(u1) == np.sign(u2)) > 0.99


def test_simclutter_data_parallel_matches_jax(world, model, jax_sim,
                                              tmp_path):
    """mesh data 2, two epochs: JAX's loss history and eval metrics; one
    checkpoint, the last epoch's, written by the first rank only."""
    res = _sim(world, tmp_path, (2,), D, model)
    _close(res["hist"], jax_sim.result())
    ckpts = [f for f in res["files"] if f.endswith(".npz")]
    assert len(ckpts) == 1 and ckpts[0].startswith("m_epoch_1_")


@pytest.mark.parametrize("kw", [
    dict(shape=(1, 2), names=DS, spatial=True),
    dict(shape=(1, 2), names=DST, pipeline_microbatches=2),
])
def test_simclutter_spatial_and_pipeline(world, model, jax_sim, tmp_path,
                                         kw):
    """One epoch of the halo-exchange step, which is the single-device
    step's arithmetic, so its loss is JAX's; and of the pipeline, whose
    per-microbatch statistics make another loss, finite, the same on
    every rank."""
    res = _sim(world, tmp_path, epoch_nums=1, model=model, **kw)
    want = jax_sim.result()
    if kw.get("spatial"):
        np.testing.assert_allclose(res["hist"]["loss"][0], want["loss"][0],
                                   rtol=1e-4)
    assert np.isfinite(res["hist"]["loss"][0])
    assert list(res["hist"]["eval"]) == [0]


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]
