"""The port's data, checkpoint, registry, log and augmentation modules
(onet_tpu_torch/data, core/checkpoint, models/arch, report/logs) against
the JAX package's, on the CPU.

Checkpoints cross in both directions with bit-equal arrays (params, BN
state and Adam state under the same keys), equal '__meta__' and epoch.
The augmentation helpers take the parameters JAX drew (from the same key
splits the JAX functions use) and must give the same uint8 frames: equal
for every step that ends in a rounding or is exact (equalize, CLAHE,
defocus, dropouts, flip, the whole compose), 1e-4 gray levels for the
unrounded Gaussian blur (f32 convolution in another order), 1e-6 for
brightness/contrast.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.core import checkpoint as JC
from onet_tpu.data import augment as JA
from onet_tpu.data.arrays import ArrayDataset as JArrayDataset
from onet_tpu.data.simclutter import (load_simclutter_pt as j_load_pt,
                                      simclutter_datasets as j_datasets)
from onet_tpu.models.arch import arch_meta as j_arch_meta
from onet_tpu.report import logs as JL
from onet_tpu.train.optim import adam_init as j_adam_init
from onet_tpu.train.simclutter import SimclutterConfig as JConfig

from onet_tpu_torch.core import checkpoint as TC
from onet_tpu_torch.core.bridge import from_jax_numpy
from onet_tpu_torch.core.prng import RngStream
from onet_tpu_torch.data import augment as TA
from onet_tpu_torch.data.arrays import (ArrayDataset, batch_iterator,
                                        num_batches, train_test_split)
from onet_tpu_torch.data.simclutter import (filter_by_snr_range,
                                            load_simclutter_pt,
                                            simclutter_datasets)
from onet_tpu_torch.models import arch as TArch
from onet_tpu_torch.models.onet import onet_init
from onet_tpu_torch.models.unet import tree_leaves, tree_map
from onet_tpu_torch.report import logs as TL
from onet_tpu_torch.train.optim import adam_init
from onet_tpu_torch.train.simclutter import SimclutterConfig


def _gen(seed=0):
    return RngStream(seed, "cpu").next()


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------

def test_array_dataset_and_batches():
    with pytest.raises(ValueError, match="ragged"):
        ArrayDataset({"a": torch.zeros(3), "b": torch.zeros(4)})
    ds = ArrayDataset({"a": torch.arange(23), "b": torch.arange(23) * 2})
    assert len(ds) == 23 and ds.device.type == "cpu"
    plain = list(batch_iterator(ds, 5))
    assert [len(b["a"]) for b in plain] == [5, 5, 5, 5, 3]
    assert torch.equal(torch.cat([b["a"] for b in plain]), ds["a"])
    assert len(list(batch_iterator(ds, 5, drop_last=True))) == 4
    assert num_batches(23, 5) == 5 and num_batches(23, 5, True) == 4
    shuf = list(batch_iterator(ds, 5, gen=_gen(1)))
    order = torch.cat([b["a"] for b in shuf])
    assert sorted(order.tolist()) == list(range(23))
    assert not torch.equal(order, ds["a"])
    assert all(torch.equal(b["b"], b["a"] * 2) for b in shuf)
    again = torch.cat([b["a"] for b in batch_iterator(ds, 5, gen=_gen(1))])
    assert torch.equal(order, again)
    tr, te = train_test_split(ds, _gen(2))
    assert (len(tr), len(te)) == (20, 3)
    assert sorted(torch.cat([tr["a"], te["a"]]).tolist()) == list(range(23))


# ---------------------------------------------------------------------------
# simclutter datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def source():
    """A JAX-style source: 4 levels x 5 frames, not normalized."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(-2, 5, (20, 16, 16, 1)).astype(np.float32)
    labels = (rng.uniform(size=(20, 16, 16)) > 0.8).astype(np.float32)
    psnr = np.repeat(np.arange(4), 5).astype(np.int32)
    return imgs, labels, psnr


@pytest.mark.parametrize("equal_split", [False, True])
def test_simclutter_datasets_match_jax(source, equal_split):
    imgs, labels, psnr = source
    jsrc = JArrayDataset({"imgs": jnp.asarray(imgs),
                          "labels": jnp.asarray(labels),
                          "psnr": jnp.asarray(psnr)})
    tsrc = ArrayDataset({"imgs": torch.tensor(imgs),
                         "labels": torch.tensor(labels),
                         "psnr": torch.tensor(psnr)})
    jtr, jte = j_datasets(jax.random.key(0), source=jsrc, low_snr=1,
                          high_snr=3, equal_split=equal_split)
    ttr, tte = simclutter_datasets(_gen(), source=tsrc, low_snr=1,
                                   high_snr=3, equal_split=equal_split,
                                   device="cpu")
    assert (len(ttr), len(tte)) == (len(jtr), len(jte))
    # the same frames, normalized the same way, whatever the permutation
    ref = {}
    for ds in (jtr, jte):
        for im, lab, p in zip(np.asarray(ds["imgs"]), np.asarray(ds["labels"]),
                              np.asarray(ds["psnr"])):
            ref[lab.tobytes()] = (im, int(p))
    for ds in (ttr, tte):
        for im, lab, p in zip(ds["imgs"].numpy(), ds["labels"].numpy(),
                              ds["psnr"].tolist()):
            want, wp = ref.pop(lab.tobytes())
            assert p == wp
            np.testing.assert_allclose(im, want, rtol=0, atol=1e-6)
    assert not ref
    if equal_split:
        for j, t in ((jtr, ttr), (jte, tte)):
            assert np.bincount(np.asarray(j["psnr"])).tolist() == \
                torch.bincount(t["psnr"]).tolist()
    assert filter_by_snr_range(tsrc, 2, 2)["psnr"].tolist() == [2] * 5


def test_load_simclutter_pt_matches_jax(tmp_path, source):
    imgs, labels, psnr = source
    path = str(tmp_path / "rayleigh_2sigma.pt")
    torch.save({"rayleigh_imgs": torch.tensor(imgs).permute(0, 3, 1, 2),
                "rayleigh_labels": torch.tensor(labels),
                "psnr": psnr.tolist()}, path)
    got = load_simclutter_pt(path, device="cpu")
    want = j_load_pt(path)
    for k in ("imgs", "labels", "psnr"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["psnr"].dtype == torch.int32


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """JAX trees of params, BN state and a non-trivial Adam state at base
    8 (the port's init as JAX arrays: the trees' structure is the JAX
    package's, and its eager init compiles for seconds)."""
    params, bn = (tree_map(lambda t: jnp.asarray(t.numpy()), t) for t in
                  onet_init(_gen(9), 1, base=8, device="cpu"))
    rng = np.random.default_rng(4)
    rand = lambda t: jax.tree.map(            # noqa: E731
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        t)
    opt = j_adam_init(params)._replace(count=jnp.asarray(7, jnp.int32),
                                       mu=rand(params), nu=rand(params))
    return params, rand(bn), opt


META = {"arch": "vanilla", "in_channels": 1, "weight_share": True,
        "base_channels": 8}


def _port_state(jax_state):
    params, bn, opt = jax_state
    tp, tb = from_jax_numpy(params, bn, device="cpu")
    to = {"count": torch.tensor(int(opt.count), dtype=torch.int32),
          "mu": from_jax_numpy(opt.mu, {}, device="cpu")[0],
          "nu": from_jax_numpy(opt.nu, {}, device="cpu")[0]}
    return tp, tb, to


def _assert_bits(port_tree, jax_tree):
    got = [t.numpy() for t in tree_leaves(port_tree)]
    want = [np.asarray(a) for a in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_port_checkpoint_loads_in_jax(tmp_path, jax_state):
    params, bn, opt = jax_state
    tp, tb, to = _port_state(jax_state)
    path = str(tmp_path / "port.npz")
    snapshot = tree_map(torch.clone, tp)
    writer = TC.AsyncCheckpointWriter()
    writer.save(path, tp, tb, 12, opt_state=to, meta=META)
    tree_map(lambda t: t.add_(1.0), tp)       # the next step, in place
    writer.wait()
    jp, jb, ep, jo = JC.load_checkpoint(path, params, bn, opt_template=opt)
    assert ep == 12 and JC.read_checkpoint_meta(path) == META
    _assert_bits(snapshot, jp)
    _assert_bits(tb, jb)
    assert int(jo.count) == 7 and np.asarray(jo.count).dtype == np.int32
    _assert_bits(to["mu"], jo.mu)
    _assert_bits(to["nu"], jo.nu)
    with np.load(path) as z:
        assert "o:.count" in z.files and "p:top/inc/conv1/w" in z.files
        assert set(z.files) == set(np.load(_jax_file(tmp_path,
                                                     jax_state)).files)


def _jax_file(tmp_path, jax_state):
    path = str(tmp_path / "jax.npz")
    if not os.path.exists(path):
        params, bn, opt = jax_state
        JC.save_checkpoint(path, params, bn, 9, opt_state=opt, meta=META)
    return path


def test_jax_checkpoint_loads_in_port(tmp_path, jax_state):
    params, bn, opt = jax_state
    path = _jax_file(tmp_path, jax_state)
    tp, tb = onet_init(_gen(), 1, base=8, device="cpu")
    tp, tb, ep, to = TC.load_checkpoint(path, tp, tb,
                                        opt_template=adam_init(tp))
    assert ep == 9 and TC.read_checkpoint_meta(path) == META
    _assert_bits(tp, params)
    _assert_bits(tb, bn)
    assert to["count"].dtype == torch.int32 and int(to["count"]) == 7
    _assert_bits(to["mu"], opt.mu)
    _assert_bits(to["nu"], opt.nu)
    arch, ap, ab, ae = TC.load_arch_auto(path, device="cpu")
    assert arch.vanilla and ae == 9
    _assert_bits(ap, params)
    # a file without optimizer state, and a model it does not fit
    old = str(tmp_path / "old.npz")
    JC.save_checkpoint(old, params, bn, 3)
    assert TC.load_checkpoint(old, tp, tb, opt_template=to)[3] is None
    wide, wide_bn = onet_init(_gen(), 1, base=16, device="cpu")
    with pytest.raises(ValueError, match="has shape"):
        TC.load_checkpoint(path, wide, wide_bn)
    twin, twin_bn = onet_init(_gen(), 1, base=8, weight_share=False,
                              device="cpu")
    with pytest.raises(KeyError, match="p:down/"):
        TC.load_checkpoint(path, twin, twin_bn)


def test_atomic_save_and_rotation(tmp_path, monkeypatch):
    tp, tb = onet_init(_gen(), 1, base=8, device="cpu")
    path = str(tmp_path / "m_epoch_300_x.npz")
    TC.save_checkpoint(path, tp, tb, 300)
    assert os.listdir(tmp_path) == ["m_epoch_300_x.npz"]
    os.utime(path, (1000, 1000))            # the oldest file

    def broken(f, **kw):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError):
        TC.save_checkpoint(path, tp, tb, 301)
    monkeypatch.undo()
    assert TC.load_checkpoint(path, tp, tb)[2] == 300   # untouched
    os.remove(path + ".tmp")
    for i in range(4):
        p = str(tmp_path / f"m_autosave_{i}_x.npz")
        TC.save_checkpoint(p, tp, tb, i)
        os.utime(p, (2000 + i, 2000 + i))
    deleted = TC.rotate_checkpoints(str(tmp_path), keep=2,
                                    pattern="m_autosave_*.npz")
    assert sorted(os.path.basename(d) for d in deleted) == \
        ["m_autosave_0_x.npz", "m_autosave_1_x.npz"]
    assert os.path.exists(path)
    assert TC.latest_checkpoint(str(tmp_path)).endswith("m_autosave_3_x.npz")


def test_async_writer_reraises_io_errors(tmp_path):
    tp, tb = onet_init(_gen(), 1, base=8, device="cpu")
    w = TC.AsyncCheckpointWriter()
    bad = tmp_path / "taken.npz"
    bad.mkdir()                 # os.replace onto a directory fails
    w.save(str(bad), tp, tb, 1)
    with pytest.raises(OSError):
        w.wait()
    good = str(tmp_path / "ok.npz")
    w.save(good, tp, tb, 2, rotate=(str(tmp_path), 1, "ok*.npz"))
    w.wait()
    assert TC.load_checkpoint(good, tp, tb)[2] == 2


# ---------------------------------------------------------------------------
# registry and logs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(base_channels=8, in_channels=3, weight_share=False),
    dict(arch="swin", swin_window=8, swin_embed=48),
    dict(arch="transunet", transunet_embed=96, transunet_depth=2)])
def test_arch_meta_matches_jax(kw):
    meta = TArch.arch_meta(SimclutterConfig(**kw))
    assert meta == j_arch_meta(JConfig(**kw))
    json.dumps(meta)
    if meta["arch"] == "vanilla":
        assert TArch.arch_from_meta(meta).vanilla
    else:
        arch = TArch.arch_from_meta(meta)
        assert arch.name == meta["arch"] and not arch.vanilla
    with pytest.raises(ValueError):
        TArch.get_arch("resnet")


def test_epoch_log_line_matches_jax(monkeypatch):
    class Fixed:
        @staticmethod
        def now():
            return "2025-04-07 12:00:00.000000"

    monkeypatch.setattr(JL, "datetime", Fixed)
    monkeypatch.setattr(TL, "datetime", Fixed)
    metrics = {"acc": 0.912345, "miou": 0.5, "tiou": 0.25, "dr": 0.75,
               "far": 1.234e-5}
    for m in (metrics, {"acc": 0.5}):
        assert TL.epoch_log_line("onet", 42, 0.123456789, 5e-6, m) == \
            JL.epoch_log_line("onet", 42, 0.123456789, 5e-6, m)


def test_training_curves_png(tmp_path):
    from onet_tpu_torch.report.curves import save_training_curves

    path = save_training_curves(str(tmp_path / "c" / "loss.png"),
                                [3.0, 2.5], {0: {"acc": 0.5, "miou": 0.4},
                                             1: {"acc": 0.6, "miou": 0.5}})
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

def _u8(seed, h=32, w=32):
    return np.round(np.random.default_rng(seed).random((h, w))
                    * 255).astype(np.float32)


def test_augment_helpers_match_jax():
    u8 = _u8(0)
    t = torch.tensor(u8)
    np.testing.assert_array_equal(TA.equalize_u8(t).numpy(),
                                  np.asarray(JA.equalize_u8(jnp.asarray(u8))))
    np.testing.assert_array_equal(TA.clahe_u8(t).numpy(),
                                  np.asarray(JA.clahe_u8(jnp.asarray(u8))))
    for i in range(6):
        k = jax.random.key(i)
        ky, kx = jax.random.split(k)
        np.testing.assert_array_equal(
            TA.defocus_u8(t, int(jax.random.randint(k, (), 3, 11))).numpy(),
            np.asarray(JA.defocus_u8(k, jnp.asarray(u8))))
        ys = jax.random.randint(ky, (8,), 0, 32 - 8 + 1)
        xs = jax.random.randint(kx, (8,), 0, 32 - 8 + 1)
        np.testing.assert_array_equal(
            TA.coarse_dropout_u8(t, torch.tensor(np.asarray(ys)),
                                 torch.tensor(np.asarray(xs))).numpy(),
            np.asarray(JA.coarse_dropout_u8(k, jnp.asarray(u8))))
        kb, kc = jax.random.split(k)
        beta = jax.random.uniform(kb, (), minval=0.04, maxval=0.38)
        alpha = 1.0 + jax.random.uniform(kc, (), minval=-0.19, maxval=0.35)
        x = u8[..., None] / 255.0
        np.testing.assert_allclose(
            TA.brightness_contrast(torch.tensor(x), float(alpha),
                                   float(beta)).numpy(),
            np.asarray(JA.brightness_contrast(k, jnp.asarray(x))), atol=1e-6)
    for sigma in (0.5, 1.3, 2.0):
        np.testing.assert_allclose(
            TA.gaussian_blur(t[..., None], sigma).numpy(),
            np.asarray(JA.gaussian_blur(jnp.asarray(u8)[..., None], sigma)),
            rtol=0, atol=1e-4)


def _jax_compose_draws(key, h, w):
    """The choices simclutter_pixel_augment_one draws from ``key``."""
    ks = jax.random.split(key, 16)
    take = [bool(jax.random.uniform(ks[i]) < p)
            for i, p in zip((0, 2, 3, 4, 7, 8, 10, 12, 14), TA._P)]
    kb, kc = jax.random.split(ks[9])
    ky, kx = jax.random.split(ks[13])
    d = dict(take=np.array(take),
             radius=jax.random.randint(ks[1], (), 3, 11),
             keep1=jax.random.bernoulli(ks[5], 0.99, (h, w)),
             sigma=jax.random.uniform(ks[6], (), minval=0.5, maxval=2.0),
             beta=jax.random.uniform(kb, (), minval=0.04, maxval=0.38),
             alpha=1.0 + jax.random.uniform(kc, (), minval=-0.19,
                                            maxval=0.35),
             keep2=jax.random.bernoulli(ks[11], 0.99, (h, w)),
             ys=jax.random.randint(ky, (8,), 0, h - 8 + 1),
             xs=jax.random.randint(kx, (8,), 0, w - 8 + 1))
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def test_pixel_augment_compose_matches_jax():
    """40 frames and keys: every step fires on some of them (counted)."""
    fired = np.zeros(9, int)
    for i in range(40):
        img = (_u8(100 + i) / 255.0)[..., None]
        key = jax.random.key(i)
        d = _jax_compose_draws(key, 32, 32)
        fired += d["take"].numpy()
        got = TA.apply_pixel_augment(torch.tensor(img), d).numpy()
        want = np.asarray(JA.simclutter_pixel_augment_one(key,
                                                          jnp.asarray(img)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert fired.min() > 0, fired
    out = TA.simclutter_pixel_augment(_gen(3), torch.rand(3, 32, 32, 1))
    assert out.shape == (3, 32, 32, 1) and torch.isfinite(out).all()
