"""The port's sweeps, NAU transfer and two-stage Onet
(onet_tpu_torch/data/zy3.py, data/nau.py, train/nau.py, train/two_stage.py,
train/sweeps.py) against the JAX package's, on the CPU, in fp32.

Setup: base 8, 32x32 frames; two seeded inits carried to JAX as trees and
back through ``core/bridge.from_jax_numpy``; the simclutter levels 0 and
10 (10 frames each, JAX-generated at 64x64 and cropped to 32) and 10
synthetic NAU rain frames of 32x32 (the JAX package's
``synthesize_nau_rain``) converted to torch. JAX's draws are reused where
the port draws from a ``torch.Generator``.

Tolerances:
* ``smooth_noise_from`` and ``nau_rain_from`` on JAX's draws: images within
  1e-5; rain masks equal except where the rain texture lies within 1e-5 of
  its frame's quantile threshold (none on these draws).
* the NAU loader: bit-equal (both min-max the same float32 frames).
* ``test_naurain``, ``verify_two_stage``, ``test_by_snr``,
  ``verify_checkpoint_dir``: every segmentation metric within one pixel's
  share of a 32x32 frame (1/1024); the flip decision equal; the SNR
  figures (dB) within 1e-3 dB.
* ``threshold_sweep_by_snr``: far within one negative pixel's share of the
  level and dr within one positive pixel's (a score within rounding of a
  threshold may compare either way).
* ``train_by_snr``: each level bit-equal to a direct ``train()`` of its
  config, from the same init.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.data import nau as JNAU
from onet_tpu.data import zy3 as JZ
from onet_tpu.data.arrays import ArrayDataset as JArrayDataset
from onet_tpu.models import onet as JO
from onet_tpu.sim.rayleigh import rayleigh_frames as j_rayleigh_frames
from onet_tpu.sim.targets import rayleigh_sample as j_rayleigh_sample
from onet_tpu.train import nau as JN
from onet_tpu.train import sweeps as JS
from onet_tpu.train import two_stage as JT

from onet_tpu_torch.core.bridge import from_jax_numpy
from onet_tpu_torch.core.checkpoint import save_checkpoint
from onet_tpu_torch.core.prng import derive_seed, make_generator
from onet_tpu_torch.data import nau as TNAU
from onet_tpu_torch.data import zy3 as TZ
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.data.simclutter import simclutter_datasets
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.models.unet import tree_leaves
from onet_tpu_torch.train import nau as TN
from onet_tpu_torch.train import simclutter as TSC
from onet_tpu_torch.train import sweeps as TS
from onet_tpu_torch.train import two_stage as TT

PIXEL = 1.0 / (32 * 32)        # one pixel's share of a frame
SEG = ("acc", "miou", "dr", "far", "tiou")
# JAX compiles each jitted function once per shape: every batch here is 5
# frames (levels of 10, NAU of 10) and the JAX step factories are cached
J_FWD = jax.jit(JO.onet_forward, static_argnames=("train",))
J_SMOOTH = jax.jit(JZ._smooth_noise, static_argnums=(1, 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where several test
    processes share the cores, a parallel region waits for threads that
    are not scheduled and a millisecond op takes tens of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(tree):
    """A port tree as the JAX package's (the same nesting), copied."""
    return jax.tree.map(lambda t: jnp.asarray(np.array(t.numpy(),
                                                       copy=True)), tree)


def _to_port(ds):
    return ArrayDataset({k: torch.tensor(np.array(v)) for k, v in
                         ds.data.items()})


@pytest.fixture(scope="module")
def nets():
    """Two seeded inits (stage 1, stage 2), as JAX trees and port trees
    (the port's init: JAX's eager init compiles op by op)."""
    out = []
    for seed in (11, 12):
        tp = TO.onet_init(torch.Generator().manual_seed(seed), 1, base=8,
                          device="cpu")
        jp = tuple(_jax_tree(t) for t in tp)
        out.append((jp, from_jax_numpy(*(jax.tree.map(np.asarray, t)
                                         for t in jp), device="cpu")))
    return out


@pytest.fixture(scope="module", autouse=True)
def cached_jax_steps(nets):
    """The JAX sweeps build a new jitted step per call (and its checkpoint
    loader an eager init per file): hand them one of each, so JAX compiles
    each function once. What they compute is unchanged."""
    steps = {}

    def cached(make):
        def get(**kw):
            key = (make, tuple(sorted(kw.items())))
            if key not in steps:
                steps[key] = make(**kw)
            return steps[key]
        return get

    template = nets[0][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "make_eval_step", cached(JS.make_eval_step))
        mp.setattr(JT, "make_two_stage_eval", cached(JT.make_two_stage_eval))
        mp.setattr(JN, "make_transfer_eval", cached(JN.make_transfer_eval))
        mp.setattr(JO, "onet_init", lambda *a, **kw: template)
        yield


@pytest.fixture(scope="module")
def levels():
    """{0: ds, 10: ds} of 10 frames each, as JAX and as the port."""
    jds = {}
    for lvl in (0, 10):
        f, m = j_rayleigh_frames(jax.random.key(100 + lvl), float(lvl),
                                 n_frames=10, frame_size=64, crop=32)
        jds[lvl] = JArrayDataset({"imgs": f[..., None], "labels": m})
    return jds, {k: _to_port(v) for k, v in jds.items()}


@pytest.fixture(scope="module")
def nau():
    """10 NAU rain frames of 32x32 (jitted: eager, vmap compiles op by
    op), as JAX and as the port, and their ids."""
    data = jax.jit(lambda k: JNAU.synthesize_nau_rain(k, n=10, size=32)[0]
                   .data)(jax.random.key(5))
    ds = JArrayDataset(data)
    return ds, _to_port(ds), [f"nau_syn_{i:03d}" for i in range(10)]


def _close_metrics(got, want, tol=PIXEL):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= tol, (k, got[k], want[k])


def test_smooth_noise_from_matches_jax():
    key = jax.random.key(21)
    for shape, cutoff in (((32, 32), 0.015), ((40, 24), 0.04)):
        want = np.asarray(J_SMOOTH(key, shape, cutoff))
        noise = np.asarray(jax.random.normal(key, shape))
        got = TZ.smooth_noise_from(torch.tensor(noise), cutoff).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    g = torch.Generator().manual_seed(0)
    batch = TZ.smooth_noise(g, (3, 16, 16), 0.04)
    assert batch.shape == (3, 16, 16)
    assert torch.allclose(batch.amin((1, 2)), torch.zeros(3))


def test_nau_rain_from_matches_jax(nau):
    jds, _, ids = nau
    n, size, cover = 10, 32, 0.25
    bgs, noises, rains = [], [], []
    for k in jax.random.split(jax.random.key(5), n):   # JAX's own draws
        kb, kr = jax.random.split(k)
        bgs.append(np.asarray(j_rayleigh_sample(kb, (size, size))))
        noises.append(np.asarray(jax.random.normal(kr, (size, size))))
        rains.append(np.asarray(J_SMOOTH(kr, (size, size), 0.015)))
    imgs, masks = TNAU.nau_rain_from(torch.tensor(np.stack(bgs)),
                                     torch.tensor(np.stack(noises)), cover)
    assert imgs.shape == (n, size, size, 1) and masks.dtype == torch.float32
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jds["imgs"]),
                               atol=1e-5, rtol=0)
    rain = np.stack(rains)
    thr = np.quantile(rain.reshape(n, -1), 1 - cover, axis=1)[:, None, None]
    near = np.abs(rain - thr) <= 1e-5
    differ = masks.numpy() != np.asarray(jds["labels"])
    assert not np.any(differ & ~near)
    assert abs(float(masks.mean()) - cover) < 0.01
    ds, got_ids = TNAU.synthesize_nau_rain(torch.Generator().manual_seed(1),
                                           n=3, size=32, device="cpu")
    assert got_ids == ids[:3] and ds["imgs"].shape == (3, 32, 32, 1)


def test_load_nau_dict_pt_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    d = {f"frame_{i}": {
        "img": torch.tensor(rng.rayleigh(1.0, (32, 32)).astype(np.float32)),
        "label": torch.tensor((rng.random((32, 32)) < 0.2)
                              .astype(np.float32))} for i in range(3)}
    path = str(tmp_path / "nau.pt")
    torch.save(d, path)
    jds, jids = JNAU.load_nau_dict_pt(path)
    tds, tids = TNAU.load_nau_dict_pt(path, device="cpu")
    assert tids == jids == list(d)
    for k in ("imgs", "labels"):
        np.testing.assert_array_equal(tds[k].numpy(), np.asarray(jds[k]))


def _flipped(pkg_params, x, labels, jax_side):
    """The flip decision of one batch: any(raw argmax != aligned)."""
    if jax_side:
        from onet_tpu.metrics.segmentation import align_labels_by_accuracy
        out, _ = J_FWD(*pkg_params, jnp.asarray(x), train=False)
        raw = JO.predict_label(out.S)
        return bool(jnp.any(raw != align_labels_by_accuracy(
            raw, jnp.asarray(labels))))
    from onet_tpu_torch.metrics.segmentation import align_labels_by_accuracy
    with torch.no_grad():
        out, _ = TO.onet_forward(*pkg_params, torch.tensor(x), train=False)
    raw = TO.predict_label(out.S)
    return bool(torch.any(raw != align_labels_by_accuracy(
        raw, torch.tensor(labels))))


def test_naurain_matches_jax(nets, nau, tmp_path):
    (jp, tp), _ = nets
    jds, tds, ids = nau
    want = JN.test_naurain(*jp, jds, batch_sz=5, ids=ids)
    fig = str(tmp_path / "nau.png")
    got = TN.test_naurain(*tp, tds, batch_sz=5, ids=ids, fig_path=fig)
    assert os.path.getsize(fig) > 0
    _close_metrics({k: got[k] for k in SEG}, {k: want[k] for k in SEG})
    _close_metrics({k: got[k] for k in TN.SNR_KEYS},
                   {k: want[k] for k in TN.SNR_KEYS}, tol=1e-3)
    x, lab = np.asarray(jds["imgs"][:5]), np.asarray(jds["labels"][:5])
    assert _flipped(jp, x, lab, True) == _flipped(tp, x, lab, False)
    # forward= takes a backbone family's forward; the vanilla one given
    # explicitly is the default
    xt, lt = torch.tensor(x), torch.tensor(lab)
    a = TN.make_transfer_eval(forward=TO.onet_forward)(*tp, xt, lt)
    b = TN.make_transfer_eval()(*tp, xt, lt)
    assert all(torch.equal(a[0][k], b[0][k]) for k in b[0])
    assert torch.equal(a[2], b[2])


def test_verify_two_stage_matches_jax(nets, levels, tmp_path):
    (jp1, tp1), (jp2, tp2) = nets
    jds, tds = levels
    want = JT.verify_two_stage(*jp1, *jp2, jds, batch_sz=5)
    got = TT.verify_two_stage(*tp1, *tp2, tds, batch_sz=5)
    assert list(got) == list(want) == [0, 10, "ave"]
    for lvl in got:
        for stage in ("stage1", "stage2"):
            _close_metrics(got[lvl][stage], want[lvl][stage])
    # the stage-2 input: equal maps only if the flip decision is equal
    jev = JT.make_two_stage_eval()
    tev = TT.make_two_stage_eval()
    for lvl in (0, 10):
        x, lab = jds[lvl]["imgs"][:5], jds[lvl]["labels"][:5]
        jx2 = np.asarray(jev(*jp1, *jp2, x, lab)[4][0])
        tx2 = tev(*tp1, *tp2, torch.tensor(np.asarray(x)),
                  torch.tensor(np.asarray(lab)))[4][0].numpy()
        np.testing.assert_allclose(tx2, jx2, atol=1e-4, rtol=0)
        x, lab = np.asarray(x), np.asarray(lab)
        assert _flipped(jp1, x, lab, True) == _flipped(tp1, x, lab, False)
    fig = str(tmp_path / "two_stage.png")
    batch = {k: v[:5] for k, v in tds[10].data.items()}
    TT.draw_two_stage(fig, tev, *tp1, *tp2, batch)
    assert os.path.getsize(fig) > 0


def test_test_by_snr_matches_jax(nets, levels):
    (jp, tp), _ = nets
    jds, tds = levels
    want = JS.test_by_snr(*jp, jds, batch_sz=5)
    got = TS.test_by_snr(*tp, tds, batch_sz=5)
    assert list(got) == list(want)
    for lvl in want:
        _close_metrics(got[lvl], want[lvl])


def test_threshold_sweep_by_snr_matches_jax(nets, levels):
    (jp, tp), _ = nets
    jds, tds = levels
    budgets = (1e-3, 1e-2, 5e-2, 1e-1)
    want = JS.threshold_sweep_by_snr(*jp, jds, far_budgets=budgets)
    got = TS.threshold_sweep_by_snr(*tp, tds, far_budgets=budgets)
    assert list(got) == list(want)
    for lvl in want:
        y = tds[lvl]["labels"] > 0
        one_neg = 1.0 / int((~y).sum())
        one_pos = 1.0 / max(int(y.sum()), 1)
        for k, tol in (("far", one_neg), ("dr", one_pos)):
            assert abs(got[lvl]["argmax"][k] - want[lvl]["argmax"][k]) <= tol
        assert list(got[lvl]["thresh"]) == list(want[lvl]["thresh"])
        for b, w in want[lvl]["thresh"].items():
            g = got[lvl]["thresh"][b]
            if np.isnan(w["far"]):
                assert np.isnan(g["far"]) and np.isnan(g["dr"])
                continue
            assert g["far"] <= b and abs(g["far"] - w["far"]) <= one_neg
            assert abs(g["dr"] - w["dr"]) <= one_pos


def test_verify_checkpoint_dir_matches_jax(nets, levels, tmp_path):
    (_, tp1), (_, tp2) = nets
    jds, tds = levels
    save_checkpoint(str(tmp_path / "a_epoch_3.npz"), *tp1, 3)
    save_checkpoint(str(tmp_path / "b_epoch_7.npz"), *tp2, 7)
    want = JS.verify_checkpoint_dir(str(tmp_path), datasets_by_psnr=jds,
                                    batch_sz=5)
    got = TS.verify_checkpoint_dir(str(tmp_path), datasets_by_psnr=tds,
                                   batch_sz=5, device="cpu")
    assert list(got) == list(want) == ["a_epoch_3.npz", "b_epoch_7.npz"]
    for f in want:
        assert (got[f]["epoch"], got[f]["arch"]) == \
            (want[f]["epoch"], want[f]["arch"])
        for lvl in want[f]["per_snr"]:
            _close_metrics(got[f]["per_snr"][lvl], want[f]["per_snr"][lvl])
    # a file whose meta names another family than its tree holds is
    # refused by the key its family's tree misses
    save_checkpoint(str(tmp_path / "c.npz"), *tp1, 0,
                    meta={"arch": "swin", "in_channels": 1,
                          "weight_share": True, "swin_window": 2,
                          "swin_embed": 12})
    with pytest.raises(KeyError, match="checkpoint has no 'p:top/"):
        TS.verify_checkpoint_dir(str(tmp_path), datasets_by_psnr=tds,
                                 batch_sz=5, device="cpu")


def test_per_snr_datasets_derive_a_seed_per_level():
    got = TS.per_snr_datasets(3, levels=(0, 4), frames_per_level=2, crop=32,
                              device="cpu")
    assert list(got) == [0, 4]
    for lvl, ds in got.items():
        want, rest = simclutter_datasets(
            make_generator(derive_seed(3, 1000 + lvl), "cpu"), low_snr=lvl,
            high_snr=lvl, train_frac=1.0, frames_per_level=2, crop=32,
            device="cpu")
        assert len(rest) == 0 and len(ds) == 2
        assert all(torch.equal(ds[k], want[k]) for k in want.data)
        assert torch.all(ds["psnr"] == lvl)


def test_train_by_snr_is_train_per_level(tmp_path):
    base = TSC.SimclutterConfig(
        model_name="m", epoch_nums=1, input_sz=32, base_channels=8,
        frames_per_level=4, save_epochs=(), out_root=str(tmp_path))
    got = TS.train_by_snr(base, levels=(0, 3), device="cpu")
    assert list(got) == [0, 3]
    for lvl, (params, bn, hist) in got.items():
        cfg = dataclasses.replace(
            base, low_snr=lvl, high_snr=lvl,
            out_root=str(tmp_path / f"direct_{lvl}"))
        p2, bn2, h2 = TSC.train(cfg, log=False, device="cpu")
        assert hist == h2
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params) + tree_leaves(bn),
            tree_leaves(p2) + tree_leaves(bn2)))
        assert os.listdir(tmp_path / f"onet_snr_{lvl:02d}")
    # the same init for every level: zero epochs return it untouched
    init = TS.train_by_snr(dataclasses.replace(base, epoch_nums=0),
                           levels=(0, 3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(init[0][0]), tree_leaves(init[3][0])))
