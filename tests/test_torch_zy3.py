"""The port's ZY-3 data, augmentation, dehazing, preprocessing, report and
curation modules (onet_tpu_torch/data/zy3.py, data/augment.py,
preprocess/haze.py, preprocess/image.py, report/xlsx.py, report/tables.py,
report/curves.py, preprocess/curation.py, preprocess/onramp.py,
utils/summary.py) against the JAX package's, on the CPU, in fp32.

The deterministic parts run on JAX's own draws (its white noise, tints,
angles, fields and selectors, taken from the same keys the JAX functions
split), so they are held to JAX's outputs directly. A base-8 net from
the port's seeded init goes to JAX as trees and comes back through
``core/bridge.from_jax_numpy``; the JAX forwards are jitted (eager ones
compile op by op).

Tolerances:
* scenes and cloud addition: images within 1e-5; masks equal except where
  the cloud texture lies within 1e-5 of its frame's quantile threshold
  (measured: none on these draws);
* every augmentation op and both batch composes: within 1e-5, masks equal
  (measured: none differ); the samplers also at the frame's border and at
  half-integer coordinates;
* dehaze's J and K, every stage: within 1e-5 of the JAX functions run op
  by op (measured: equal), with a tied plateau in the dark channel whose
  pixels differ in colour (the light depends on which of them the top set
  keeps); and within 1e-5 of the jitted ``dehaze`` on the frames without
  the plateau. On the plateau the guided filter divides a covariance by a
  variance near its eps, and XLA's fused arithmetic moves J by 2.9e-4
  there against the JAX package's own op-by-op run (measured);
* equalize and contrast: equal; the nine options: within 1e-5 except
  where the value before the truncation to uint8 lies within 1e-3 of a
  level, and there by one level (measured, of 6,912 values a frame: 803
  and 639 on the frame of four grey levels for histeq_haze_enhance and
  histeq_haze_remove, whose values land on levels; 1 on the frame with a
  flat channel for contrast_enhance_haze_remove; none elsewhere);
* the resize: within 1 uint8 level on at most 1% of pixels (measured:
  none on 130x160 -> 30 and 40x48 -> 60; 1e-5 of pixels on 300x400 ->
  224, 7e-4 on 60x50 -> 40); a mask thumbnail equal except where its
  resized value sits at the 0.5 threshold (measured: 2 of 2,304 pixels);
* the report: the same workbook parts, byte for byte, from the same rows;
* curation and on-ramp: the same options chosen and the same scores
  within 1e-5.
"""

import os
import zipfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.data import augment as JA
from onet_tpu.data import zy3 as JZ
from onet_tpu.data.arrays import ArrayDataset as JArrayDataset
from onet_tpu.models import onet as JO
from onet_tpu.preprocess import curation as JC
from onet_tpu.preprocess import haze as JH
from onet_tpu.preprocess import image as JI
from onet_tpu.preprocess import onramp as JR
from onet_tpu.report import tables as JTab
from onet_tpu.report import xlsx as JX
from onet_tpu.utils import summary as JSum

from onet_tpu_torch.core.bridge import from_jax_numpy
from onet_tpu_torch.data import augment as TA
from onet_tpu_torch.data import zy3 as TZ
from onet_tpu_torch.data.arrays import ArrayDataset
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.preprocess import curation as TC
from onet_tpu_torch.preprocess import haze as TH
from onet_tpu_torch.preprocess import image as TI
from onet_tpu_torch.preprocess import onramp as TR
from onet_tpu_torch.report import curves as TCurves
from onet_tpu_torch.report import tables as TTab
from onet_tpu_torch.report import xlsx as TX
from onet_tpu_torch.utils import summary as TSum

J_FWD = jax.jit(JO.onet_forward, static_argnames=("train",))
S = 32                       # frame size of the scene and augment cases



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where several test
    processes share the cores, a parallel region waits for threads that
    are not scheduled and a millisecond op takes tens of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.tensor(np.array(a))


def _u8(x):
    return (np.asarray(x) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def net():
    """A base-8, 3-channel net from the port's seeded init (JAX's eager
    init compiles op by op): (JAX trees, port trees, bridged back)."""
    tp = TO.onet_init(torch.Generator().manual_seed(2), 3, base=8,
                      device="cpu")
    jp = tuple(jax.tree.map(lambda t: np.array(t.numpy(), copy=True), t)
               for t in tp)
    return jp, from_jax_numpy(*jp, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_forward():
    """The JAX curation and on-ramp call onet_forward eagerly: hand them
    the jitted one (the same function), so each shape compiles once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, "onet_forward", J_FWD)
        yield


# ---------------------------------------------------------------------------
# data/zy3.py
# ---------------------------------------------------------------------------

def _scene_draws(key, n, lo, hi):
    """JAX's own draws of synthesize_zy3 / synthesize_cloud_addition."""
    def one(k):
        kt, kc, ktint = jax.random.split(k, 3)
        return (jax.random.normal(kt, (S, S)), jax.random.normal(kc, (S, S)),
                jax.random.uniform(ktint, (3,), minval=lo, maxval=hi))
    return [_t(a) for a in jax.jit(jax.vmap(one))(jax.random.split(key, n))]


def _clouds_near_threshold(noise_c, cover):
    cl = TZ.smooth_noise_from(noise_c, TZ.CLOUD_CUTOFF).numpy()
    thr = np.quantile(cl.reshape(len(cl), -1), 1 - cover, axis=1)
    return np.abs(cl - thr[:, None, None]) <= 1e-5


@pytest.mark.parametrize("kind", ["scene", "cloud_addition"])
def test_scenes_on_jax_draws(kind):
    key, cover = jax.random.key(11), 0.35
    if kind == "scene":
        want = jax.jit(lambda k: JZ.synthesize_zy3(k, n=4, size=S)[0]
                       .data)(key)
        nt, nc, tint = _scene_draws(key, 4, 0.15, 0.55)
        imgs, masks = TZ.zy3_scene_from(nt, nc, tint, cover)
    else:
        want = jax.jit(lambda k: JZ.synthesize_cloud_addition(
            k, n=4, size=S)[0].data)(key)
        nt, nc, tint = _scene_draws(key, 4, 0.3, 0.8)
        terrain, imgs, masks = TZ.cloud_addition_from(nt, nc, tint, cover)
        np.testing.assert_allclose(terrain.numpy(), want["terrain"],
                                   atol=1e-5, rtol=0)
    assert imgs.shape == (4, S, S, 3) and masks.shape == (4, S, S)
    np.testing.assert_allclose(imgs.numpy(), want["imgs"], atol=1e-5, rtol=0)
    differ = masks.numpy() != np.asarray(want["labels"])
    assert not np.any(differ & ~_clouds_near_threshold(nc, cover))
    assert abs(float(masks.mean()) - cover) < 0.01


def test_synthesize_zy3_draws_on_its_generator():
    g = torch.Generator().manual_seed(3)
    ds, ids = TZ.synthesize_zy3(g, n=3, size=S, device="cpu")
    again, _ = TZ.synthesize_zy3(torch.Generator().manual_seed(3), n=3,
                                 size=S, device="cpu")
    assert ids == [f"zy3_syn_{i:04d}" for i in range(3)]
    assert ds["imgs"].shape == (3, S, S, 3) and ds["labels"].shape == (3, S, S)
    assert torch.equal(ds["imgs"], again["imgs"])
    assert 0.0 <= float(ds["imgs"].min()) and float(ds["imgs"].max()) <= 1.0
    add, add_ids = TZ.synthesize_cloud_addition(g, n=2, size=S, device="cpu")
    assert add_ids == ["zy3_add_0000", "zy3_add_0001"]
    assert set(add.data) == {"terrain", "imgs", "labels"}
    with pytest.raises(ValueError, match="generator"):
        TZ.synthesize_zy3(torch.Generator(), n=1, size=8, device="meta")


def test_load_zy3_dict_pt_and_snow_split_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    d = {f"zy3_{i}": {
        "true_color": torch.tensor(rng.random((3, 16, 16)).astype(
            np.float32)),
        "mask": torch.tensor(rng.integers(0, 3, (16, 16)).astype(
            np.float32))} for i in range(3)}
    path = str(tmp_path / "zy3.pt")
    torch.save(d, path)
    jds, jids = JZ.load_zy3_dict_pt(path)
    tds, tids = TZ.load_zy3_dict_pt(path, device="cpu")
    assert tids == jids == list(d)
    for k in ("imgs", "labels"):
        np.testing.assert_array_equal(tds[k].numpy(), np.asarray(jds[k]))
    for got, want in zip(TZ.split_snow_mask(tds["labels"]),
                         JZ.split_snow_mask(jds["labels"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_supervised_batches():
    g = torch.Generator().manual_seed(5)
    ds, ids = TZ.synthesize_zy3(g, n=5, size=S, device="cpu")
    ds.data["labels"] = ds["labels"] * 2.0          # a {0, 2} (snow) mask
    plain = list(TZ.supervised_batches(g, ds, ids, 2, aug=False,
                                       snow_split=True))
    assert [b["ids"] for b in plain] == [ids[:2], ids[2:4], ids[4:]]
    assert torch.equal(torch.cat([b["imgs"] for b in plain]), ds["imgs"])
    assert torch.equal(plain[0]["snow"], (ds["labels"][:2] == 2).float())
    assert float(plain[0]["cloud"].sum()) == 0.0
    aug = list(TZ.supervised_batches(g, ds, ids, 2))
    assert sorted(i for b in aug for i in b["ids"]) == sorted(ids)
    for b in aug:
        assert set(torch.unique(b["labels"]).tolist()) <= {0.0, 2.0}


# ---------------------------------------------------------------------------
# data/augment.py
# ---------------------------------------------------------------------------

def _jax_draws(key, b):
    """JAX's own draws of augment_batch(key, .) (the same splits and folds
    as _augment_one), in draw_zy3_augment's layout."""
    def one(k):
        ks = jax.random.split(k, 8)
        kd = jax.random.fold_in(k, 55)
        kbc, kp = jax.random.split(jax.random.fold_in(k, 99))
        kb, kc = jax.random.split(kbc)
        kex, key_ = jax.random.split(jax.random.fold_in(kd, 2))
        kgx, kgy = jax.random.split(jax.random.fold_in(kd, 3))

        def u(kk, shape, lo, hi):
            return jax.random.uniform(kk, shape, minval=lo, maxval=hi)

        return dict(
            take_geo=jax.random.uniform(ks[0]) < 0.8,
            geo=jax.random.randint(ks[1], (), 0, 3),
            take_rot=jax.random.uniform(ks[3]) < 0.2,
            angle=u(ks[2], (), -jnp.pi / 2, jnp.pi / 2),
            take_snow=jax.random.uniform(ks[4]) < 0.1,
            snow_q=u(jax.random.split(ks[5], 1)[0], (), 0.8, 0.9),
            take_distort=jax.random.uniform(ks[7]) < 0.1,
            distort=jax.random.randint(jax.random.fold_in(kd, 1), (), 0, 3),
            sigma=u(ks[6], (), 0.5, 2.0),
            dx=u(kex, (S, S), -1.0, 1.0), dy=u(key_, (S, S), -1.0, 1.0),
            grid_y=1.0 + u(kgy, (5,), -0.3, 0.3),
            grid_x=1.0 + u(kgx, (5,), -0.3, 0.3),
            take_bc=jax.random.uniform(kp) < 0.1,
            beta=u(kb, (), 0.04, 0.38),
            alpha=1.0 + u(kc, (), -0.19, 0.35))
    return {k: _t(v) for k, v in
            jax.jit(jax.vmap(one))(jax.random.split(key, b)).items()}


# 48 frames from key 0 take every step and every branch at least once
AUG_B, AUG_KEY = 48, 0


@pytest.fixture(scope="module")
def aug_case():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (AUG_B, S, S, 3)).astype(np.float32)
    m = (rng.uniform(0, 1, (AUG_B, S, S)) > 0.5).astype(np.float32)
    key = jax.random.key(AUG_KEY)
    return x, m, key, _jax_draws(key, AUG_B)


def test_compose_draws_cover_every_branch(aug_case):
    d = aug_case[3]
    for k in ("take_geo", "take_rot", "take_snow", "take_bc"):
        assert d[k].any() and not d[k].all(), k
    for s in range(3):
        assert (d["take_geo"] & (d["geo"] == s)).any()
        assert (d["take_distort"] & (d["distort"] == s)).any()


def test_augment_batch_matches_jax(aug_case):
    x, _, key, d = aug_case
    want = np.asarray(JA.augment_batch(key, jnp.asarray(x)))
    got = TA.apply_zy3_augment(torch.tensor(x), d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_augment_batch_with_masks_matches_jax(aug_case):
    x, m, key, d = aug_case
    wi, wm = JA.augment_batch_with_masks(key, jnp.asarray(x), jnp.asarray(m))
    gi, gm = TA.apply_zy3_augment(torch.tensor(x), d, torch.tensor(m))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def _vmapped(fn, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(*args))


@pytest.mark.parametrize("op", ["hflip", "vflip", "transpose", "rotate",
                                "snow", "elastic", "grid", "blur",
                                "brightness_contrast", "dropout"])
def test_augment_op_matches_jax(aug_case, op):
    """Each step alone on 4 frames, with JAX's draws for those frames."""
    x, _, key, d = aug_case
    x, keys = x[:4], jax.random.split(key, AUG_B)[:4]
    d = {k: v[:4] for k, v in d.items()}
    xj, xt = jnp.asarray(x), torch.tensor(x)
    if op in ("hflip", "vflip", "transpose"):
        s = ("hflip", "vflip", "transpose").index(op)
        want = [x[:, :, ::-1], x[:, ::-1], x.transpose(0, 2, 1, 3)][s]
        got = TA.geometric(xt, torch.full((4,), s))
    elif op == "rotate":
        want = _vmapped(JA.rotate, xj, jnp.asarray(d["angle"].numpy()))
        got = TA.rotate(xt, d["angle"])
    elif op == "snow":
        ks = jax.vmap(lambda k: jax.random.split(k, 8)[5])(keys)
        want = _vmapped(JA.random_snow, ks, xj)
        got = TA.random_snow(xt, d["snow_q"])
    elif op == "elastic":
        kd = jax.vmap(lambda k: jax.random.fold_in(
            jax.random.fold_in(k, 55), 2))(keys)
        want = _vmapped(JA.elastic_warp, kd, xj)
        got = TA.elastic_warp(xt, d["dx"], d["dy"])
    elif op == "grid":
        kd = jax.vmap(lambda k: jax.random.fold_in(
            jax.random.fold_in(k, 55), 3))(keys)
        want = _vmapped(JA.grid_distortion, kd, xj)
        got = TA.grid_distortion(xt, d["grid_y"], d["grid_x"])
    elif op == "blur":
        want = _vmapped(JA.gaussian_blur, xj, jnp.asarray(d["sigma"].numpy()))
        got = TA.gaussian_blur_frames(xt, d["sigma"])
    elif op == "brightness_contrast":
        kbc = jax.vmap(lambda k: jax.random.split(
            jax.random.fold_in(k, 99))[0])(keys)
        want = _vmapped(JA.brightness_contrast, kbc, xj)
        got = TA.brightness_contrast(xt, d["alpha"][:, None, None, None],
                                     d["beta"][:, None, None, None])
    else:
        want = _vmapped(JA.pixel_dropout, keys, xj)
        keep = jax.vmap(lambda k: jax.random.bernoulli(k, 0.99, (S, S)))(keys)
        got = TA.pixel_dropout(xt, _t(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_samplers_at_the_border_match_jax():
    """Coordinates outside, on and between the edges, and half-integers
    (the nearest sampler rounds half to even, as jnp.round)."""
    rng = np.random.default_rng(12)
    img = rng.uniform(0, 1, (6, 7, 3)).astype(np.float32)
    mask = rng.integers(0, 3, (6, 7)).astype(np.float32)
    vals_y = np.array([-1.5, -1.0, -0.5, -0.25, 0.0, 0.5, 1.5, 2.5, 4.5,
                       5.0, 5.25, 5.5, 6.0, 6.5], np.float32)
    vals_x = np.array([-1.0, -0.5, 0.0, 0.5, 3.5, 5.5, 6.0, 6.25, 6.5, 7.0,
                       7.5, -0.75, 2.0, 1.5], np.float32)
    yy, xx = np.meshgrid(vals_y, vals_x, indexing="ij")
    yy, xx = yy[None], xx[None]
    want = np.asarray(JA._bilinear_sample(jnp.asarray(img), yy[0], xx[0]))
    got = TA._bilinear_sample(torch.tensor(img)[None], torch.tensor(yy),
                              torch.tensor(xx))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    want = np.asarray(JA._nearest_sample(jnp.asarray(mask), yy[0], xx[0]))
    got = TA._nearest_sample(torch.tensor(mask)[None], torch.tensor(yy),
                             torch.tensor(xx))[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_draws_on_its_generator():
    x = torch.rand(3, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    m = (x[..., 0] > 0.5).float()
    a = TA.augment_batch(torch.Generator().manual_seed(1), x)
    b = TA.augment_batch(torch.Generator().manual_seed(1), x)
    assert a.shape == x.shape and torch.equal(a, b)
    d = TA.draw_zy3_augment(torch.Generator().manual_seed(2), 3, 16, 16)
    for k in ("take_geo", "take_rot", "take_snow", "take_distort",
              "take_bc"):
        d[k] = torch.zeros(3, dtype=torch.bool)
    img, msk = TA.apply_zy3_augment(x, d, m)       # nothing taken
    assert torch.equal(img, x) and torch.equal(msk, m)
    gi, gm = TA.augment_batch_with_masks(torch.Generator().manual_seed(3),
                                         x, m)
    assert gi.shape == x.shape and gm.shape == m.shape
    with pytest.raises(ValueError, match="square"):
        TA.geometric(torch.zeros(1, 4, 6, 1), torch.zeros(1))


# ---------------------------------------------------------------------------
# preprocess/haze.py, preprocess/image.py, utils/summary.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hazy():
    """Three 50x50 frames (numpx = 2); the first holds a plateau in the
    dark channel (every pixel's min is 0.95) whose pixels differ in their
    other channels, brighter than the rest of the frame."""
    rng = np.random.default_rng(13)
    im = rng.uniform(0, 0.8, (3, 50, 50, 3)).astype(np.float32)
    im[0, 10:20, 10:30] = rng.uniform(0.95, 1.0, (10, 20, 3))
    im[0, 10:20, 10:30, 0] = 0.95
    return im


def test_atm_light_keeps_xla_top_k_order_on_a_plateau(hazy):
    im = torch.tensor(hazy[:1])
    dark = TH.dark_channel(im, 3)
    assert int((dark[0] == dark.max()).sum()) > 2       # a tied top set
    want = np.asarray(JH.atm_light(jnp.asarray(hazy[0]),
                                   JH.dark_channel(jnp.asarray(hazy[0]), 3)))
    np.testing.assert_allclose(TH.atm_light(im, dark)[0].numpy(), want,
                               atol=1e-6, rtol=0)


def test_dehaze_stages_match_jax(hazy):
    im = torch.tensor(hazy)
    dark = TH.dark_channel(im, 3)
    a = TH.atm_light(im, dark)
    te = TH.transmission_estimate(im, a, 3)
    t = TH.transmission_refine(im, te, 3, 1e-4)
    j, k = TH.dehaze(im)
    for n, frame in enumerate(hazy):
        f = jnp.asarray(frame)
        jd = JH.dark_channel(f, 3)
        ja = JH.atm_light(f, jd)
        jte = JH.transmission_estimate(f, ja, 3)
        jt = JH.transmission_refine(f, jte, 3, 1e-4)
        with jax.disable_jit():
            jj, jk = JH.dehaze(f)
        for got, want in ((dark, jd), (a, ja), (te, jte), (t, jt), (j, jj),
                          (k, jk)):
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)
        if n:        # the jitted dehaze, away from the plateau (see above)
            for got, want in zip((j, k), JH.dehaze(f)):
                np.testing.assert_allclose(got[n].numpy(), np.asarray(want),
                                           atol=1e-5, rtol=0)
    j1, k1 = TH.dehaze(im[1])                       # one [H, W, 3] frame
    assert torch.equal(j1, j[1]) and torch.equal(TH.haze_radiance(im), k)


def test_dehaze_below_2000_pixels_stays_finite():
    im = torch.rand(1, 20, 20, 3, generator=torch.Generator().manual_seed(1))
    j, k = TH.dehaze(im)
    jj, jk = JH.dehaze(jnp.asarray(im[0].numpy()))
    assert bool(torch.isfinite(j).all()) and bool(torch.isfinite(k).all())
    np.testing.assert_allclose(j[0].numpy(), np.asarray(jj), atol=1e-5)
    np.testing.assert_allclose(k[0].numpy(), np.asarray(jk), atol=1e-5)


@pytest.fixture(scope="module")
def thumbs():
    """Four uint8 48x48 thumbnails: random, four grey levels, one flat
    channel, and a narrow range."""
    rng = np.random.default_rng(14)
    u8 = rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8)
    u8[1] = (u8[1] // 64) * 64 + 10
    u8[2, ..., 1] = 7
    u8[3] = u8[3] // 3 + 100
    return u8


@pytest.mark.parametrize("fn", ["equalize_uint8", "contrast_enhance"])
def test_lut_stages_equal_jax(thumbs, fn):
    want = np.stack([getattr(JI, fn)(u) for u in thumbs])
    got = getattr(TI, fn)(torch.tensor(thumbs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        getattr(TI, fn)(torch.tensor(thumbs[0])).numpy(), want[0])


def _before_truncation(u8, option):
    """The JAX option's float value before its uint8 truncation (None for
    the options without a dehaze term)."""
    if "haze" not in option:
        return None
    base = (JI.equalize_uint8(u8) if option.startswith("histeq_") else
            JI.contrast_enhance(u8) if option.startswith("contrast_enhance_")
            else u8)
    i = base.astype(np.float32) / 255.0
    j, k = (np.asarray(v) for v in JH.dehaze(jnp.asarray(i)))
    if option.endswith("haze_remove"):
        return np.clip(j, 0, 1) * 255
    gain = np.float32(1.0 if option == "haze_enhance" else 1.7)
    return np.clip(i + (gain * k)[..., None], 0, 1) * 255


@pytest.mark.parametrize("option", JI.PRE_OPTIONS)
def test_pre_options_match_jax(thumbs, option):
    got = TI.apply_pre_option(torch.tensor(thumbs), option).numpy()
    assert got.dtype == np.float32 and got.shape == thumbs.shape
    for n, u8 in enumerate(thumbs):
        want = JI.apply_pre_option(u8, option)
        off = np.abs(got[n] - want) > 1e-5
        if off.any():
            v = _before_truncation(u8, option)
            near = np.abs(v - np.round(v)) <= 1e-3
            assert not np.any(off & ~near), (option, n)
            assert np.abs(got[n] - want).max() <= 1.0 / 255 + 1e-6


@pytest.mark.parametrize("shape,target", [((130, 160, 3), 30),
                                          ((300, 400, 3), 224),
                                          ((60, 50, 3), 40),
                                          ((40, 48, 3), 60)])
def test_resize_within_one_level(shape, target):
    img = np.random.default_rng(15).integers(0, 256, shape, dtype=np.uint8)
    want = JI.rgb_resize_smaller_edge(img, target)
    got = TI.rgb_resize_smaller_edge(torch.tensor(img), target).numpy()
    assert got.shape == want.shape and min(got.shape[:2]) == target
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    th = TI.thumbnail_rgb(torch.tensor(img), resize_to=target, crop=24)
    np.testing.assert_array_equal(
        th.numpy(), JI.center_crop_hw(got, 24))


def test_scr_db_matches_jax(thumbs):
    img = thumbs[0].astype(np.float32) / 255
    lab = (np.random.default_rng(16).random((48, 48)) < 0.2).astype(
        np.float32)
    want = float(JSum.scr_db(jnp.asarray(img), jnp.asarray(lab)[..., None]))
    got = TSum.get_scr(torch.tensor(img), torch.tensor(lab)[..., None])
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# report/xlsx.py, report/tables.py, report/curves.py
# ---------------------------------------------------------------------------

def _report_rows(n=3, seed=17):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append({"img_id": f"zy3_{i}", "acc": float(rng.random()),
                     "miou": float(rng.random()), "group": i % 2 - 1,
                     "rgb": rng.random((8, 8, 3)).astype(np.float32),
                     **{k: rng.random((8, 8)).astype(np.float32)
                        for k in ("label", "pred", "vt", "vd")}})
    return rows


def _parts(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_excel_report_equals_jax(tmp_path):
    import pandas as pd

    rows = _report_rows()
    summary = pd.DataFrame([{"group": "all", "n": 3, "acc": 0.5,
                             "miou": 0.25},
                            {"group": "detector@far<=0.01", "n": 3,
                             "dr": 0.4, "far": 0.01, "threshold": 1.5}])
    a = JTab.save_zy3_excel_report(str(tmp_path / "j.xlsx"), rows, summary)
    b = TTab.save_zy3_excel_report(str(tmp_path / "t.xlsx"), rows, summary)
    pa, pb = _parts(a), _parts(b)
    assert pa == pb
    assert sum(n.endswith(".png") for n in pb) == 5 * len(rows)
    df = TTab.per_image_table(["a", "b"], {"acc": np.array([0.5, 1.0])})
    groups = {"g": ["a"]}
    pd.testing.assert_frame_equal(TTab.grouped_summary(df, groups),
                                  JTab.grouped_summary(df, groups))
    assert _parts(TTab.save_report(str(tmp_path / "t2.xlsx"), df)) == \
        _parts(JTab.save_report(str(tmp_path / "j2.xlsx"), df))
    assert TTab.sort_results(rows) == JTab.sort_results(rows)
    assert [TX.col_letter(c) for c in (1, 26, 27, 703)] == \
        [JX.col_letter(c) for c in (1, 26, 27, 703)]


@pytest.mark.parametrize("fn", ["save_result_grid", "save_segmentation_grid",
                                "save_adversarial_grid", "save_tensor_matrix",
                                "save_loss_acc_curves",
                                "save_test_res_grids"])
def test_figures_are_written(tmp_path, fn):
    rng = np.random.default_rng(18)
    x = rng.random((5, 8, 8, 3)).astype(np.float32)
    m = (rng.random((5, 8, 8)) > 0.5).astype(np.float32)
    path = str(tmp_path / f"{fn}.png")
    f = getattr(TCurves, fn)
    if fn == "save_result_grid":
        out = [f(path, x, m, m, m, m, title="t")]
    elif fn in ("save_segmentation_grid",):
        out = [f(path, x, m, m, title="t")]
    elif fn == "save_adversarial_grid":
        out = [f(path, x, m, m, m, title="t")]
    elif fn == "save_tensor_matrix":
        out = [f(path, [x, m, m], title="t")]
    elif fn == "save_loss_acc_curves":
        out = [f(path, [1.0, 0.5], [0.6, 0.7], [0.4, 0.5])]
    else:
        out = f(str(tmp_path), "m", _report_rows(5), test_loss=0.1, acc=0.5,
                miou=0.4, epoch=3)
        assert len(out) == 1 and "epoch_003" in out[0]
    assert all(os.path.getsize(p) > 0 for p in out)


# ---------------------------------------------------------------------------
# preprocess/curation.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """Six JAX-made 32x32 scenes: (JAX dataset, port dataset, ids)."""
    data = jax.jit(lambda k: JZ.synthesize_zy3(k, n=6, size=S)[0].data)(
        jax.random.key(19))
    jds = JArrayDataset(data)
    return jds, ArrayDataset({k: _t(v) for k, v in data.items()}), \
        [f"zy3_syn_{i:04d}" for i in range(6)]


def test_segment_trainset_report_matches_jax(net, scenes):
    jds, tds, ids = scenes
    want = JC.segment_trainset_report(*net[0], jds, ids, batch_sz=3)
    got = TC.segment_trainset_report(*net[1], tds, ids, batch_sz=3)
    assert [r["img_id"] for r in got] == [r["img_id"] for r in want]
    np.testing.assert_allclose([r["fg_coverage"] for r in got],
                               [r["fg_coverage"] for r in want], atol=1e-5)


def test_divide_and_division_table_match_jax(scenes, tmp_path):
    import pandas as pd

    jds, tds, ids = scenes
    table = tmp_path / "division.csv"
    pd.DataFrame({"group": ["a", "a", "b"],
                  "img_id": [ids[0], ids[2], ids[4]]}).to_csv(table,
                                                              index=False)
    groups = TC.load_division_table(str(table))
    assert groups == JC.load_division_table(str(table))
    sub, sub_ids = TC.divide_by_id_lists(tds, ids, groups["a"])
    jsub, jsub_ids = JC.divide_by_id_lists(jds, ids, groups["a"])
    assert sub_ids == jsub_ids == [ids[0], ids[2]]
    np.testing.assert_array_equal(sub["imgs"].numpy(), np.asarray(jsub["imgs"]))


def test_choose_best_preprocess_matches_jax(net, scenes):
    jds, tds, ids = scenes
    opts = ("raw_rgb", "histeq_rgb", "haze_enhance", "contrast_enhance")
    u8s = [_u8(jds["imgs"][i]) for i in range(2)]
    labs = [np.asarray(jds["labels"][i]) for i in range(2)]
    jbest, jrows = JC.choose_best_preprocess(*net[0], u8s, labs, ids[:2],
                                             options=opts)
    best, rows = TC.choose_best_preprocess(
        *net[1], [torch.tensor(u) for u in u8s],
        [torch.tensor(m) for m in labs], ids[:2], options=opts)
    assert [(r["img_id"], r["option"]) for r in rows] == \
        [(r["img_id"], r["option"]) for r in jrows]
    for r, w in zip(rows, jrows):
        assert abs(r["acc"] - w["acc"]) <= 1e-5
        assert abs(r["miou"] - w["miou"]) <= 1e-5
    for name in ids[:2]:
        assert best[name]["option"] == jbest[name]["option"]
        np.testing.assert_allclose(best[name]["img"].numpy(),
                                   jbest[name]["img"], atol=1e-5)
    groups = {"snow_cloud": [ids[0]], "normal_cloud": [ids[1]]}
    got = TC.classified_preprocess([torch.tensor(u) for u in u8s], ids[:2],
                                   groups)
    want = JC.classified_preprocess(u8s, ids[:2], groups)
    for name in ids[:2]:
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=1e-5)


def test_make_thumbnail_mask_matches_jax():
    """Equal except where the resized mask, at one uint8 level from the
    JAX resize, lies at the 0.5 threshold (127 or 128)."""
    m = (np.random.default_rng(20).random((90, 100)) > 0.5).astype(
        np.float32)
    resized = JI.center_crop_hw(JI.rgb_resize_smaller_edge(
        m[..., None].astype(np.uint8) * 255, 60), 48)[..., 0]
    at_threshold = (resized == 127) | (resized == 128)
    for img_id in ("xyz", "1706158599"):
        want = JC.make_thumbnail_mask(m, img_id, resize_to=60, crop=48)
        got = TC.make_thumbnail_mask(torch.tensor(m), img_id, resize_to=60,
                                     crop=48)
        assert got.shape == (48, 48)
        differ = got.numpy() != want
        assert not np.any(differ & ~at_threshold)
        assert differ.mean() <= 0.01


# ---------------------------------------------------------------------------
# preprocess/onramp.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    """Three RGB scenes (one of them the strong option's id) and a
    grayscale one, 130x160, with their mask PNGs."""
    from PIL import Image

    rng = np.random.default_rng(7)
    src = tmp_path_factory.mktemp("zy3src")
    msk = tmp_path_factory.mktemp("zy3mask")
    for i in ("1700000001", "1700000002", "1706158599"):
        Image.fromarray(rng.integers(0, 255, (130, 160, 3), dtype=np.uint8)
                        ).save(src / f"scene_{i}.png")
        Image.fromarray(((rng.random((130, 160)) > 0.6) * 255).astype(
            np.uint8)).save(msk / f"label_{i}.png")
    gray = rng.integers(0, 255, (130, 160), dtype=np.uint8)
    Image.fromarray(gray).save(src / "scene_1700000003.png")
    Image.fromarray((gray > 128).astype(np.uint8) * 255).save(
        msk / "label_1700000003.png")
    return (TR.list_scene_files(str(src)), TR.list_scene_files(str(msk)))


def test_prepare_thumbnails_and_dict_match_jax(scene_dirs, tmp_path):
    files, masks = scene_dirs
    assert [TR.id_from_filename(f) for f in files] == \
        [JR.id_from_filename(f) for f in files]
    want, jids = JR.prepare_zy3_thumbnails(files, masks, resize_to=30,
                                           crop=24)
    got, ids = TR.prepare_zy3_thumbnails(files, masks, resize_to=30, crop=24,
                                         device="cpu")
    assert ids == jids
    for pid in ids:
        np.testing.assert_array_equal(got[pid]["img"].numpy(),
                                      want[pid]["img"])
        np.testing.assert_array_equal(got[pid]["mask"].numpy(),
                                      want[pid]["mask"])
    path = TR.save_zy3_dict(str(tmp_path / "prep.pt"), got, "zy3_test_")
    ds, loaded = TZ.load_zy3_dict_pt(path, device="cpu")
    assert loaded == ["zy3_test_" + i for i in ids]
    assert ds["imgs"].shape == (4, 24, 24, 3)
    np.testing.assert_array_equal(ds["labels"][0].numpy(),
                                  want[ids[0]]["mask"])
    npz = TR.save_zy3_dict(str(tmp_path / "prep.npz"), got)
    with np.load(npz) as z:
        assert z["imgs"].shape == (4, 24, 24, 3) and list(z["ids"]) == ids


@pytest.mark.parametrize("mode", ["oracle", "classified"])
def test_choose_preprocess_matches_jax(net, scene_dirs, tmp_path, mode):
    files, masks = scene_dirs
    kw = dict(resize_to=30, crop=24)
    groups = {"snow_cloud": ["1700000001"], "thin_cloud": ["1700000002"]}
    if mode == "oracle":
        opts = ("raw_rgb", "histeq_rgb", "haze_enhance", TR.STRONG_OPTION)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JR, "onet_forward", J_FWD)
            jbest, jrows = JR.choose_preprocess(*net[0], files, masks,
                                                options=opts, groups=groups,
                                                **kw)
        best, rows = TR.choose_preprocess(*net[1], files, masks,
                                          options=opts, groups=groups,
                                          device="cpu", **kw)
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JR, "onet_forward", J_FWD)
            jbest, jrows = JR.classified_choose(*net[0], files, masks,
                                                groups, **kw)
        best, rows = TR.classified_choose(*net[1], files, masks, groups,
                                          device="cpu", **kw)
    assert [r["img_id"] for r in rows] == [r["img_id"] for r in jrows]
    for r, w in zip(rows, jrows):
        assert set(r) == set(w) and r["opt"] == w["opt"]
        assert r["classified_type"] == w["classified_type"]
        for k in r:
            if k not in ("img_id", "opt", "classified_type"):
                assert abs(r[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])) or \
                    r[k] == w[k], (r["img_id"], k, r[k], w[k])
    for key, rec in best.items():
        np.testing.assert_allclose(rec["img"].numpy(), jbest[key]["img"],
                                   atol=1e-5)
    out = TR.write_preprocess_report(str(tmp_path / "best.xlsx"), rows)
    assert out.endswith(".xlsx") and "xl/worksheets/sheet1.xml" in _parts(out)
