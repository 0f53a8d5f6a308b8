"""The port's simulators (onet_tpu_torch/sim, core/prng) against the JAX
package's, on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the exact parts
take JAX's draws and noise fields as inputs:
* ``render`` against ``place_gaussian_targets`` with the target
  parameters drawn in the test from the same key splits: frames within
  1e-5 of their largest magnitude (f32, other summation orders for the
  clutter energy and the box moments); masks equal apart from pixels whose
  kernel value lies within 1e-6 of a target's threshold (counted and
  printed);
* ``gammaincinv`` against the JAX package's and scipy's: 1e-4 relative,
  plus the float32 conditioning of the inverse (2^-23 P / (pdf(y) y), the
  relative change of y that one float32 rounding of P makes; it matters
  only in the upper tail, P near 1), which both packages share;
* the K simulator's Hermite coefficients (1e-5 relative: three sums over
  the field in other orders), its Gaussian ACF and spectral root, and
  frames from given noise (1e-4 of their largest magnitude: the root of a
  quadratic, two FFTs and 20 Newton steps in float32);
* ``center_crop`` exactly.

The statistical parts draw from the port's own streams and hold them, at
a stated n, to the Rayleigh(1) law and to the JAX package's generator.
"""

import math

import numpy as np
import pytest
import scipy.special as ss
import scipy.stats as st

import jax
import jax.numpy as jnp
import torch

from onet_tpu.metrics import psnr_snr as j_psnr_snr
from onet_tpu.sim import kdist as JK
from onet_tpu.sim.rayleigh import (center_crop as j_center_crop,
                                   rayleigh_frames as j_rayleigh_frames)
from onet_tpu.sim.targets import (place_gaussian_targets,
                                  rayleigh_sample as j_rayleigh_sample)

from onet_tpu_torch.core.prng import RngStream
from onet_tpu_torch.metrics.segmentation import psnr_snr
from onet_tpu_torch.sim import kdist as TK
from onet_tpu_torch.sim.rayleigh import (center_crop, generate_rayleigh_dataset,
                                         rayleigh_frames)
from onet_tpu_torch.sim.targets import Targets, rayleigh_sample, render


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where several test
    processes share the cores, a parallel region waits for threads that
    are not scheduled and a millisecond op takes tens of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(key, h, w, swerling, n_targets=20):
    """The target parameters place_gaussian_targets draws from ``key``."""
    kc, kw, kh, kt, ka = jax.random.split(key, 5)
    n = (n_targets,)
    cx = w / 2 + 30.0 * jax.random.normal(kc, n)
    cy = h / 2 + 24.0 * jax.random.normal(jax.random.fold_in(kc, 1), n)
    tw = 10.0 + 2.0 * jax.random.normal(kw, n)
    th = 18.0 + 2.0 * jax.random.normal(kh, n)
    theta = jax.random.uniform(kt, n) * 180.0
    if swerling == 0:
        amp = jnp.ones(n)
    elif swerling == 1:
        amp = jnp.mean(j_rayleigh_sample(ka, (n_targets, 1000))
                       / math.sqrt(2.0), axis=1)
    else:
        df = 4.0
        amp = jnp.mean(1.0 / math.sqrt(df * 2 + df ** 2) * 2.0
                       * jax.random.gamma(ka, df / 2.0, (n_targets, 1000)),
                       axis=1)
    return [np.asarray(a, np.float32) for a in (cx, cy, tw, th, theta, amp)]


def _near_threshold(d, h, w, tol=1e-6):
    """Pixels whose kernel value lies within ``tol`` of some target's mask
    threshold, recomputed in float64 from the draws ``d``."""
    cx, cy, tw, th, theta, _ = (np.asarray(a, np.float64) for a in d)
    rows, cols = np.mgrid[:h, :w]
    near = np.zeros((h, w), bool)
    for i in range(len(cx)):
        sx = max((tw[i] / 2 - 0.5) / 2, 0.25)
        sy = max((th[i] / 2 - 0.5) / 2, 0.25)
        wr, hr = int(np.floor(sx * 2.5 + 0.5)), int(np.floor(sy * 2.5 + 0.5))
        xi = int(np.clip(np.floor(cx[i]), wr, w - wr - 1))
        yi = int(np.clip(np.floor(cy[i]), hr, h - hr - 1))
        kx, ky = cols - xi, rows - yi
        box = (np.abs(kx) <= wr) & (np.abs(ky) <= hr)
        t = -theta[i]
        a = np.cos(t) ** 2 / (2 * sx ** 2) + np.sin(t) ** 2 / (2 * sy ** 2)
        b = -np.sin(2 * t) / (4 * sx ** 2) + np.sin(2 * t) / (4 * sy ** 2)
        c = np.sin(t) ** 2 / (2 * sx ** 2) + np.cos(t) ** 2 / (2 * sy ** 2)
        k = np.where(box, np.exp(-(a * kx ** 2 + 2 * b * kx * ky
                                   + c * ky ** 2)), 0.0)
        n = (2 * wr + 1) * (2 * hr + 1)
        std = np.sqrt(max((k ** 2).sum() / n - (k.sum() / n) ** 2, 0.0))
        near |= box & (np.abs(k - (1 - 2 * std)) < tol)
    return near


@pytest.mark.parametrize("swerling,snr", [(0, 0.0), (1, 5.0), (3, 10.0)])
def test_render_matches_place_gaussian_targets(swerling, snr):
    n, h, w = 4, 64, 64
    rng = np.random.default_rng(swerling)
    clutter = rng.rayleigh(size=(n, h, w)).astype(np.float32)
    keys = [jax.random.key(10 * swerling + i) for i in range(n)]
    jf, jm, draws = [], [], []
    for i, k in enumerate(keys):
        f, m = place_gaussian_targets(k, jnp.asarray(clutter[i]), snr,
                                      swerling=swerling)
        jf.append(np.asarray(f))
        jm.append(np.asarray(m))
        draws.append(_jax_draws(k, h, w, swerling))
    tg = Targets(*(torch.tensor(np.stack([d[j] for d in draws]))
                   for j in range(6)))
    frames, masks = render(torch.tensor(clutter), snr, tg)
    jf, jm = np.stack(jf), np.stack(jm)
    np.testing.assert_allclose(frames.numpy(), jf, rtol=0,
                               atol=1e-5 * np.abs(jf).max())
    near = np.stack([_near_threshold(d, h, w) for d in draws])
    differ = masks.numpy() != jm
    print(f"swerling {swerling}: {int(near.sum())} pixels within 1e-6 of a "
          f"threshold, {int(differ.sum())} mask pixels differ")
    assert not (differ & ~near).any()
    assert jm.mean() > 0.01


@pytest.mark.parametrize("a", [0.5, 1.99, 5.0, 20.0])
def test_gammaincinv_matches_jax_and_scipy(a):
    p = np.linspace(1e-5, 1 - 1e-5, 101).astype(np.float32)
    got = TK.gammaincinv(a, torch.tensor(p)).numpy().astype(np.float64)
    jx = np.asarray(JK.gammaincinv(a, jnp.asarray(p)), np.float64)
    want = ss.gammaincinv(a, p.astype(np.float64))
    pdf = np.exp((a - 1) * np.log(want) - want - math.lgamma(a))
    # one float32 rounding of P moves y by 2^-23 P / (pdf(y) y), relative
    tol = 1e-4 + 2.0 ** -23 * p / (pdf * want)
    assert np.all(np.abs(got - jx) <= tol * jx)
    assert np.all(np.abs(got - want) <= tol * want)
    assert tol[p <= 0.99].max() < 1.1e-4


@pytest.fixture(scope="module")
def kdist_pair():
    """The JAX simulator at 64x64 and the port's built on JAX's noise."""
    key = jax.random.key(11)
    jsim = JK.KDistSimulator(key, size=64)
    gwn = np.asarray(jax.random.normal(key, (64, 64), jnp.float32))
    return jsim, TK.KDistSimulator.from_noise(torch.tensor(gwn)), gwn


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_kdist_acf_matches_jax(kdist_pair):
    jsim, tsim, gwn = kdist_pair
    jc = JK.acf_poly_coeffs(jnp.asarray(gwn), JK.mnlt(jnp.asarray(gwn), 5.0))
    tc = TK.acf_poly_coeffs(torch.tensor(gwn), TK.mnlt(torch.tensor(gwn), 5.0))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    # the root solve alone, on the JAX package's coefficients
    coeffs = np.asarray(jc / jc[-1])
    _close(TK.solve_gaussian_acf(tsim.gamma_acf, torch.tensor(coeffs)),
           JK.solve_gaussian_acf(jsim.gamma_acf, jnp.asarray(coeffs)), 1e-5)
    for name in ("gamma_acf", "gaussian_acf", "f_acf_sqrt"):
        _close(getattr(tsim, name), getattr(jsim, name), 1e-4)


def test_kdist_frames_from_jax_noise(kdist_pair):
    jsim, tsim, _ = kdist_pair
    amp, gan = [], []
    n1, n2 = [], []
    for i in range(2):
        k = jax.random.key(100 + i)
        a, g = jsim.frame(k)
        amp.append(np.asarray(a))
        gan.append(np.asarray(g))
        k1, k2 = jax.random.split(k)
        n1.append(np.asarray(jax.random.normal(k1, (64, 64), jnp.float32)))
        n2.append(np.asarray(jax.random.normal(k2, (64, 64), jnp.float32)))
    ta, tg = tsim.frames_from_noise(torch.tensor(np.stack(n1)),
                                    torch.tensor(np.stack(n2)))
    _close(ta, np.stack(amp), 1e-4)
    _close(tg, np.stack(gan), 1e-4)


def test_center_crop_matches_jax():
    x = np.arange(3 * 7 * 10, dtype=np.float32).reshape(3, 7, 10)
    for size in (4, 5, 7):
        np.testing.assert_array_equal(center_crop(torch.tensor(x),
                                                  size).numpy(),
                                      np.asarray(j_center_crop(x, size)))


def test_rayleigh_background_distribution():
    """n = 20000: KS against Rayleigh(1) and against JAX's sampler."""
    got = rayleigh_sample(RngStream(3, "cpu").next(), (20000,)).numpy()
    assert st.kstest(got, "rayleigh").pvalue > 0.01
    jx = np.asarray(j_rayleigh_sample(jax.random.key(3), (20000,)))
    assert st.ks_2samp(got, jx).pvalue > 0.01
    assert np.isfinite(got).all()


def _psnr_and_mask(frames, masks, fn):
    psnrs = [float(fn(f, m)[0]) for f, m in zip(frames, masks) if m.sum() > 0]
    assert len(psnrs) >= 10
    return float(np.mean(psnrs)), float(masks.mean())


def test_rayleigh_frames_psnr_and_mask_match_jax():
    """n = 12 frames of 200^2 cropped to 128 per level. The measured peak
    PSNR rises with the level inside the band the JAX package is held to
    (level - 1 < psnr < level + 12 dB) and within 1 dB of JAX's at the
    same n (JAX's own seed-to-seed spread: 0.1-0.2 dB); the mask fraction
    lies in (0.005, 0.5) and within 0.01 of JAX's."""
    stream = RngStream(7, "cpu")
    measured = {}
    for snr in (0, 5, 10):
        f, m = rayleigh_frames(stream.next(), float(snr), n_frames=12,
                               frame_size=200, crop=128, device="cpu")
        assert f.shape == m.shape == (12, 128, 128)
        assert float(f.min()) >= 0 and float(f.max()) <= 1
        jf, jm = j_rayleigh_frames(jax.random.key(7), float(snr),
                                   n_frames=12, frame_size=200, crop=128)
        got = _psnr_and_mask(f, m, psnr_snr)
        want = _psnr_and_mask(np.asarray(jf), np.asarray(jm), j_psnr_snr)
        assert snr - 1.0 < got[0] < snr + 12.0
        assert abs(got[0] - want[0]) < 1.0, (snr, got, want)
        assert 0.005 < got[1] < 0.5 and abs(got[1] - want[1]) < 0.01
        measured[snr] = got[0]
    assert measured[0] < measured[5] < measured[10]


def test_kdist_moments_match_jax():
    """4 frames of 128^2 from each package's own streams: the texture is
    Gamma(5)-like (mean within 0.15 of JAX's, variance within 10%); the
    intensity mean within 5% of JAX's; the intensity is heavier-tailed
    than Rayleigh's exponential (excess kurtosis > 3) in both, within a
    factor of 2 of JAX's (one-sample spread 26-36 at this n)."""
    jsim = JK.KDistSimulator(jax.random.key(12), size=128)
    ja, jg = zip(*(jsim.frame(jax.random.key(i)) for i in range(4)))
    ja, jg = np.stack(ja), np.stack(jg)
    tsim = TK.KDistSimulator(RngStream(12, "cpu").next(), size=128,
                             device="cpu")
    ta, tg = (t.numpy() for t in
              tsim.frame_from_acf(RngStream(2, "cpu").next(), 4))
    assert np.isfinite(ta).all() and (tg >= 0).all()
    assert abs(tg.mean() - jg.mean()) < 0.15
    assert abs(tg.var() / jg.var() - 1) < 0.1
    ti, ji = ta ** 2, ja ** 2
    assert abs(ti.mean() / ji.mean() - 1) < 0.05
    tk, jk = st.kurtosis(ti.ravel()), st.kurtosis(ji.ravel())
    assert tk > 3 and jk > 3 and 0.5 < tk / jk < 2


@pytest.mark.parametrize("bg", ["rayleigh", "k"])
def test_same_seed_same_data(bg):
    def make(seed):
        return generate_rayleigh_dataset(
            RngStream(seed, "cpu").next(), levels=(0, 1), frames_per_level=2,
            crop=32, bg=bg, device="cpu") if bg == "rayleigh" else \
            TK.kdist_frames(RngStream(seed, "cpu").next(), 1.0, n_frames=2,
                            size=64, crop=32, device="cpu")

    a, b, c = make(5), make(5), make(6)
    leaves = (lambda d: list(d.values()) if isinstance(d, dict) else list(d))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(leaves(a)[0], leaves(c)[0])
    assert all(torch.isfinite(x.float()).all() for x in leaves(a))


@pytest.mark.parametrize("swerling", [1, 3])
def test_swerling_amplitudes_match_jax(swerling):
    """80 targets' amplitude jitter (each the mean of 1000 draws): the
    port's mean within 0.02 of JAX's (the standard error of either is
    about 0.002) and of the law's mean, sqrt(pi/2)/sqrt(2) (Swerling 1)
    or 2*2/sqrt(24) (Swerling 3)."""
    from onet_tpu_torch.sim.targets import draw_targets

    got = draw_targets(RngStream(swerling, "cpu").next(), 4, 64, 64,
                       swerling=swerling).amp.numpy()
    want = np.stack([_jax_draws(jax.random.key(i), 64, 64, swerling)[5]
                     for i in range(4)])
    law = math.sqrt(math.pi / 2) / math.sqrt(2) if swerling == 1 else \
        4 / math.sqrt(24)
    assert got.shape == want.shape == (4, 20)
    assert abs(got.mean() - want.mean()) < 0.02
    assert abs(got.mean() - law) < 0.02 and abs(want.mean() - law) < 0.02
