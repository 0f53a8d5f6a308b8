"""Numerically stable scalar math of the JSD objective (``onet_tpu/ops/math.py``).

``log1pexp`` keeps the reference's piecewise scheme and thresholds:

    x <= -37        -> exp(x)
    -37 < x <= 18   -> log1p(exp(x))
    18 < x < 33.3   -> x + exp(-x)
    x >= 33.3       -> x

in the JAX package's branch-free form: every branch gets an argument clamped
to where its exp cannot overflow, and ``torch.where`` picks the reference's
branch, so values and gradients stay finite at both ends. The clamps are
``torch.minimum``/``torch.maximum``, which split the gradient of a tie in
half as ``jnp.minimum``/``jnp.clip`` do, so the gradient at exactly -37 and
18 is the JAX package's too.
"""

from __future__ import annotations

import torch


def log1pexp(x: torch.Tensor) -> torch.Tensor:
    lo, mid, hi = (x.new_tensor(v) for v in (-37.0, 18.0, 33.3))
    x_lo = torch.minimum(x, lo)                          # exp() safe
    x_mid = torch.minimum(torch.maximum(x, lo), mid)     # log1p(exp()) safe
    x_hi = torch.maximum(x, mid)                         # exp(-x) safe
    return torch.where(
        x <= lo,
        torch.exp(x_lo),
        torch.where(x <= mid, torch.log1p(torch.exp(x_mid)),
                    torch.where(x < hi, x_hi + torch.exp(-x_hi), x)))
