"""The port's detectors (onet_tpu_torch/metrics/roc.py, metrics/cfar.py)
against the JAX package's, on the CPU, on seeded numpy inputs.

Tolerances:
* ROC thresholds within 2 float32 ulps of JAX's (the port reproduces
  XLA's compiled arithmetic: its reciprocal and multiply-add in
  ``jnp.linspace`` and ``jnp.quantile``; only libm's log and pow may differ
  by one ulp, rarely); far and dr equal wherever no score lies within 2
  ulps of a threshold (a score that close may compare either way).
* ``dr_at_far``: the same per budget, NaN in both where no threshold meets
  the budget.
* More than 2^24 negatives, which ``torch.quantile`` refuses: the port's
  thresholds equal a numpy sort and float32 interpolation of the same data
  on JAX's own quantile grid.
* CA-CFAR: masks equal except at pixels within 1e-5 * kval * bg of the
  decision (the integral images add in other orders); those are counted.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from onet_tpu.metrics import cfar as JC
from onet_tpu.metrics import roc as JR

from onet_tpu_torch.metrics import cfar as TC
from onet_tpu_torch.metrics import roc as TR


def _toy():
    """tests/test_roc.py's toy: 4x16x16, a 4x4 target per frame."""
    rng = np.random.default_rng(0)
    labels = np.zeros((4, 16, 16), np.int32)
    labels[:, 4:8, 4:8] = 1
    score = rng.normal(0, 1, labels.shape).astype(np.float32)
    score += 2.5 * labels
    return score, labels


def _sparse():
    rng = np.random.default_rng(1)
    labels = (rng.random((4, 64, 64)) < 0.05).astype(np.int32)
    score = (rng.normal(0, 1, labels.shape) + 2.0 * labels).astype(np.float32)
    return score, labels


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _near(score, thr):
    """Thresholds with a score within 2 ulps of them."""
    s = np.sort(score.reshape(-1))
    i = np.clip(np.searchsorted(s, thr), 1, s.size - 1)
    gap = np.minimum(_ulps(s[i], thr), _ulps(s[i - 1], thr))
    return gap <= 2


@pytest.mark.parametrize("data", [_toy, _sparse])
@pytest.mark.parametrize("n", [32, 64, 512])
def test_roc_points_matches_jax(data, n):
    score, labels = data()
    jf, jd, jt = (np.asarray(a) for a in
                  JR.roc_points(jnp.asarray(score), jnp.asarray(labels), n))
    tf, td, tt = (a.numpy() for a in
                  TR.roc_points(torch.tensor(score), torch.tensor(labels), n))
    assert tt.shape == (n,) and tt.dtype == np.float32
    assert _ulps(tt, jt).max() <= 2
    far_ok = ~_near(score, jt)
    np.testing.assert_array_equal(tf[far_ok], jf[far_ok])
    np.testing.assert_array_equal(td[far_ok], jd[far_ok])
    assert np.all(np.diff(tf) <= 0) and np.all(np.diff(td) <= 0)


@pytest.mark.parametrize("data", [_toy, _sparse])
def test_dr_at_far_matches_jax(data):
    score, labels = data()
    budgets = (1e-9, 1e-3, 1e-2, 5e-2, 0.1)     # 1e-9: no threshold meets it
    want = JR.dr_at_far(jnp.asarray(score), jnp.asarray(labels), budgets)
    got = TR.dr_at_far(torch.tensor(score), torch.tensor(labels), budgets)
    assert list(got) == list(want) == [float(b) for b in budgets]
    assert all(math.isnan(v) for v in got[1e-9] + want[1e-9])
    for b in budgets[1:]:
        (jf, jd, jt), (tf, td, tt) = want[b], got[b]
        assert _ulps(tt, jt) <= 2
        if not _near(score, np.float32([jt]))[0]:
            np.testing.assert_array_equal([tf, td], [jf, jd])   # NaN == NaN


def test_fg_score_matches_jax():
    rng = np.random.default_rng(2)
    vt, vd = rng.normal(size=(2, 2, 8, 8)).astype(np.float32)
    for down in (True, False):
        np.testing.assert_array_equal(
            TR.fg_score(torch.tensor(vt), torch.tensor(vd), down).numpy(),
            np.asarray(JR.fg_score(jnp.asarray(vt), jnp.asarray(vd), down)))


def test_roc_points_beyond_torch_quantile_limit():
    """17M scores, 16.83M of them negative: past torch.quantile's 2^24."""
    n_px, n = 17_000_000, 512
    rng = np.random.default_rng(3)
    score = rng.standard_normal(n_px, dtype=np.float32)
    labels = rng.random(n_px, dtype=np.float32) < 0.01
    score[labels] += 3.0
    neg = np.sort(score[~labels])
    assert neg.size > 2 ** 24
    _, _, thr = TR.roc_points(torch.from_numpy(score),
                              torch.from_numpy(labels), n)
    # JAX's own grid (roc_points' lines), then a float32 sort-and-interpolate
    qs_body = jnp.linspace(0.0, 0.99, n // 2)
    k_max = jnp.log10(jnp.maximum(jnp.float32(neg.size), 100.0))
    qs_tail = 1.0 - 10.0 ** (-jnp.linspace(2.0, k_max, n - n // 2))
    qs = np.asarray(jnp.concatenate([qs_body, qs_tail]))
    f32 = np.float32
    pos = qs * (f32(neg.size) - f32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = pos - lo
    lw = f32(1) - hw
    a = neg[np.clip(lo, 0, neg.size - 1).astype(np.int64)]
    b = neg[np.clip(hi, 0, neg.size - 1).astype(np.int64)]
    # XLA's contraction of b*hw + a*lw: one rounding of the exact sum
    want = (b.astype(np.float64) * hw + (a * lw)).astype(f32)
    np.testing.assert_array_equal(thr.numpy(), want)


def _cfar_bg(img, nref=16, mguide=8):
    """The annulus mean in float64, brute force by integral image."""
    h, w = img.shape
    ii = np.pad(np.cumsum(np.cumsum(img.astype(np.float64), 0), 1),
                ((1, 0), (1, 0)))

    def win(r):
        y0 = np.clip(np.arange(h) - r, 0, h)[:, None]
        y1 = np.clip(np.arange(h) + r + 1, 0, h)[:, None]
        x0 = np.clip(np.arange(w) - r, 0, w)[None, :]
        x1 = np.clip(np.arange(w) + r + 1, 0, w)[None, :]
        return (ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0],
                (y1 - y0) * (x1 - x0))

    (rs, rc), (gs, gc) = win(nref), win(mguide)
    return (rs - gs) / np.maximum(rc - gc, 1)


@pytest.mark.parametrize("shape", [(4, 64, 64), (1, 200, 200)])
def test_cfar_seg_batch_matches_jax(shape):
    kval = 2.0
    rng = np.random.default_rng(4)
    imgs = rng.rayleigh(1.0, size=shape).astype(np.float32)
    imgs[:, 20:26, 30:36] += 6.0                 # targets above the clutter
    want = np.asarray(JC.cfar_seg_batch(jnp.asarray(imgs[..., None]), kval))
    got = TC.cfar_seg_batch(torch.tensor(imgs[..., None]), kval)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    got = got.numpy()
    near = np.stack([np.abs(f - kval * _cfar_bg(f)) <= 1e-5 * kval
                     * _cfar_bg(f) for f in imgs])
    differ = got != want
    assert not np.any(differ & ~near), np.argwhere(differ & ~near)[:5]
    print(f"cfar {shape}: {int(near.sum())} pixels within rounding of "
          f"the decision, {int(differ.sum())} differ")
    assert 0.005 < got.mean() < 0.2
    np.testing.assert_array_equal(
        TC.cfar_seg(torch.tensor(imgs[0]), kval).numpy(), got[0])


def test_cfar_rejects_guard_wider_than_window():
    with pytest.raises(ValueError):
        TC.cfar_seg_batch(torch.zeros(1, 8, 8), nref=2, mguide=2)
