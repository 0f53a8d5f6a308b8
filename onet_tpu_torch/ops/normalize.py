"""Min-max normalization primitives (``onet_tpu/ops/normalize.py``).

``minmax_per_array`` and ``minmax_per_frame`` mirror the reference's
``array_normal`` and ``tensor_normal_per_frame``; ``complement`` builds the
adversarial input X_d = clip(1 - X + bias, 0, 1).
"""

from __future__ import annotations

import numpy as np
import torch

EPS = float(np.spacing(1.0))  # the reference's np.spacing(1) epsilon


def minmax_per_array(x: torch.Tensor) -> torch.Tensor:
    """Normalize the whole array to [0, 1]."""
    lo = torch.amin(x)
    hi = torch.amax(x)
    return (x - lo) / (hi - lo + EPS)


def minmax_per_frame(x: torch.Tensor) -> torch.Tensor:
    """Normalize each frame & channel over its spatial axes ([N, H, W, C]
    or [N, H, W])."""
    if x.ndim not in (3, 4):
        raise ValueError(
            f"expected [N,H,W,C] or [N,H,W], got shape {tuple(x.shape)}")
    lo = torch.amin(x, dim=(1, 2), keepdim=True)
    hi = torch.amax(x, dim=(1, 2), keepdim=True)
    return (x - lo) / (hi - lo + EPS)


def complement(x: torch.Tensor, bias: float = 0.0) -> torch.Tensor:
    return torch.clamp(1.0 - x + bias, 0.0, 1.0)
