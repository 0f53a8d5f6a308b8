"""ROC analysis for the projection-map detector (``onet_tpu/metrics/roc.py``).

The reference detects by argmax over the two branch projections: one fixed
operating point. This module sweeps a threshold over the foreground-branch
score map (score = V_fg - V_bg per pixel) and reports (far, dr) pairs, and
the threshold that meets a false-alarm budget.

The thresholds are computed as the JAX package computes them, not with
``torch.quantile`` or ``torch.linspace``: both differ from ``jnp`` in the
last bits, and ``torch.quantile`` refuses more than 2^24 elements. The
quantile grid follows ``jnp.linspace``'s arithmetic as XLA compiles it
(``linspace_f32``); the quantiles are ``jnp.quantile``'s linear
interpolation on sorted values (``quantile_positions``, ``interpolate``).

The scores are sorted once, negatives before positives, as int64 keys
(label bit above an order-preserving int32 image of the float), so each
threshold's detections are two binary searches: #{s > t} = n -
#{s <= t}. No threshold x pixel comparison, no boolean-mask indexing, no
host sync in ``roc_points``.
"""

from __future__ import annotations

import math

import torch

_SIGN_FLIP = 0x7FFFFFFF
_HALF = 1 << 31
_LABEL = 1 << 32
_INV_LN10 = 1.0 / math.log(10.0)


def fg_score(vt: torch.Tensor, vd: torch.Tensor, fg_is_down: bool):
    """Per-pixel detector score: foreground-branch logit minus background's
    (argmax(pred==fg) == score > 0, so threshold 0 reproduces argmax)."""
    return (vd - vt) if fg_is_down else (vt - vd)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once to float32, as XLA's CPU backend contracts a
    multiply-add (the float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def linspace_f32(start, stop, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA compiles it:
    t = iota * f32(1/div); start*(1-t) + iota*(stop*f32(1/div)), the last
    product and the sum contracted into one multiply-add; stop appended.
    ``stop`` may be a 0-d tensor (it stays on the device)."""
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    start = torch.as_tensor(start, dtype=torch.float32, device=stop.device)
    if num <= 1:
        return start.reshape(1)[:num]
    div = num - 1
    inv = torch.ones((), device=stop.device) / div     # f32 reciprocal
    iota = torch.arange(div, dtype=torch.float32, device=stop.device)
    body = _fma(iota, stop * inv, start * (1 - iota * inv))
    return torch.cat([body, stop.reshape(1)])


def quantile_positions(n, q: torch.Tensor):
    """``jnp.quantile``'s linear interpolation points for sorted values of
    which the first ``n`` (an int or a 0-d tensor) count: (low index, high
    index, low weight, high weight). Positions q*(n-1), their floor and
    ceiling and the weights are float32, as JAX computes them; the indices
    are clamped into [0, n-1] as XLA's gather clamps them. The quantile is
    ``interpolate(srt[low], srt[high], low weight, high weight)``."""
    q = q.to(torch.float32)
    n = torch.as_tensor(n, device=q.device)
    nf = n.to(torch.float32)
    pos = q * (nf - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    zero = torch.zeros((), dtype=torch.float32, device=q.device)

    def index(p):
        i = torch.clamp(p, zero, nf - 1).to(torch.int64)
        return torch.minimum(torch.clamp_min(i, 0), n.to(torch.int64) - 1)

    return index(low), index(high), 1 - hw, hw


def interpolate(lo_v, hi_v, lw, hw) -> torch.Tensor:
    """lo_v*lw + hi_v*hw, the second product and the sum contracted into
    one multiply-add, as XLA compiles ``jnp.quantile``."""
    return _fma(hi_v, hw, lo_v * lw)


def quantile(x: torch.Tensor, q) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=-1)`` for a scalar ``q`` or one ``q`` per
    row (shape ``x.shape[:-1]``, as ``vmap`` of ``jnp.quantile`` over the
    rows): one sort of the last axis and ``quantile_positions``; NaN where
    a row holds a NaN."""
    x = x.to(torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    srt = torch.sort(x, dim=-1).values
    lo, hi, lw, hw = quantile_positions(x.shape[-1], q)

    def at(i):
        return srt.gather(-1, i.expand(x.shape[:-1])[..., None])[..., 0]

    out = interpolate(at(lo), at(hi), lw, hw)
    return torch.where(torch.isnan(x).any(-1),
                       torch.full_like(out, float("nan")), out)


def _order_keys(s: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32), ordered as the floats (-0.0 taken as
    +0.0)."""
    b = (s + 0.0).view(torch.int32)
    return torch.where(b < 0, b ^ _SIGN_FLIP, b).to(torch.int64) + _HALF


def _from_keys(k: torch.Tensor) -> torch.Tensor:
    b = (k - _HALF).to(torch.int32)
    return torch.where(b < 0, b ^ _SIGN_FLIP, b).view(torch.float32)


def roc_points(score: torch.Tensor, labels: torch.Tensor, n: int = 64):
    """(far, dr, thresholds) tensors over n quantile-spaced thresholds.

    score, labels: [B, H, W]; labels binary with 1 = target. far is
    FP / GT-negatives, dr is TP / GT-positives.

    Thresholds are quantiles of the NEGATIVE-class scores, with the top
    half of the grid log-spaced toward quantile 1.0 (down to one expected
    pixel, quantile 1 - 1/n_neg), so budgets like 1e-3 resolve with
    sparse targets. A NaN score never exceeds a threshold; a NaN among the
    negatives makes every threshold NaN, as in ``jnp.quantile``."""
    s = score.reshape(-1).to(torch.float32)
    y = labels.reshape(-1) > 0
    nan = torch.isnan(s)
    nan_neg = (nan & ~y).any()
    s = torch.where(nan, torch.full_like(s, float("-inf")), s)
    keys = torch.sort(_order_keys(s) + y.to(torch.int64) * _LABEL).values
    pos = y.sum()
    neg = y.numel() - pos

    # body: linear quantiles [0, 0.99]; tail: log-spaced 1 - 10^-k down to
    # one expected pixel (quantile 1 - 1/n_neg)
    n_body = n // 2
    qs_body = linspace_f32(0.0, 0.99, n_body, device=s.device)
    # XLA takes log10 as log(x) * f32(1/ln 10) and rounds 10^x from its
    # libm: log and pow in float64, rounded to float32, agree with it to
    # within one ulp, rarely off at all
    k_max = (torch.log(torch.clamp_min(neg.to(torch.float32), 100.0)
                       .double()).float() * _INV_LN10)
    qs_tail = 1.0 - torch.pow(
        10.0, -linspace_f32(2.0, k_max, n - n_body).double()).float()
    qs = torch.cat([qs_body, qs_tail])
    # the negatives are the first `neg` keys, sorted, with no label bit
    lo, hi, lw, hw = quantile_positions(neg, qs)
    thr = interpolate(_from_keys(keys[lo]), _from_keys(keys[hi]), lw, hw)
    thr = torch.where(nan_neg, torch.full_like(thr, float("nan")), thr)

    tk = _order_keys(thr)
    fp = neg - torch.searchsorted(keys, tk, right=True)
    tp = pos - (torch.searchsorted(keys, tk + _LABEL, right=True) - neg)
    none = torch.isnan(thr)
    fp = torch.where(none, 0, fp)
    tp = torch.where(none, 0, tp)
    far = fp.to(torch.float32) / torch.clamp_min(neg, 1).to(torch.float32)
    dr = tp.to(torch.float32) / torch.clamp_min(pos, 1).to(torch.float32)
    return far, dr, thr


def dr_at_far(score: torch.Tensor, labels: torch.Tensor, far_targets,
              n: int = 512):
    """For each FAR budget, the best achievable dr (and the threshold).

    Returns {far_target: (achieved_far, dr, threshold)} as host floats,
    using the first threshold in sweep order whose far <= target (the
    highest dr that meets it); NaN where none does. One host sync."""
    far, dr, thr = roc_points(score, labels, n)
    tg = torch.tensor([float(t) for t in far_targets], dtype=torch.float32,
                      device=far.device)
    ok = far[None, :] <= tg[:, None]
    idx = torch.argmax(ok.to(torch.uint8), dim=1)      # first True
    vals = torch.stack([far[idx], dr[idx], thr[idx]], dim=1)
    vals = torch.where(ok.any(dim=1, keepdim=True), vals,
                       torch.full_like(vals, float("nan")))
    return {float(t): tuple(v) for t, v in zip(far_targets, vals.tolist())}
