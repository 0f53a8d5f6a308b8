"""InfoSeg baseline: unsupervised segmentation by local-global mutual
information (``onet_tpu/models/infoseg.py``).

The reference's NAU comparison figures evaluate an ``Infoseg`` model
trained on the simulated background set; its module is absent from the
reference, and the JAX package rebuilt the published method (Harb &
Knoebelreiter 2021): per-pixel local features, per-class global features
pooled by the soft assignment, and a Jensen-Shannon bound on the mutual
information between the two, maximized end to end.

The trunk is ``models/iic.py``'s two-scale FCN. The forward returns the
reference's (L, S, V) outputs (class logits, the own-image local-global
critic scores, the per-pixel probabilities) and the unit-norm local and
global features the loss reads. The loss scores every pixel against every
image's class features in one product ``sim`` [N, H, W, N, K]: its own
image's are the positives, the others' the negatives; a marginal-entropy
term guards against one class taking every pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models.iic import (dense32, head_init, to_device,
                                       trunk_features, trunk_init)
from onet_tpu_torch.ops.math import log1pexp

TAU = 0.5          # critic temperature on unit-norm features
# marginal-entropy weight: a mild collapse guard only (strong weights force
# a balanced split, wrong for sparse targets)
ENTROPY_W = 0.1


class InfoSegOut(NamedTuple):
    logits: torch.Tensor   # [N, H, W, K] class-head logits ("L")
    scores: torch.Tensor   # [N, H, W, K] local-global critic scores ("S")
    probs: torch.Tensor    # [N, H, W, K] soft assignment ("V")
    feats: torch.Tensor    # [N, H, W, D] unit-norm local features
    glob: torch.Tensor     # [N, K, D] unit-norm class-pooled globals


def infoseg_init(gen: torch.Generator, in_channels: int = 1,
                 k_classes: int = 2, *, base: int = 64,
                 dtype=torch.float32, device=None):
    """(params, state) of the two-scale encoder and the class head, drawn
    on the CPU from ``gen``, on ``device`` (default: the card)."""
    params, state = trunk_init(gen, in_channels, base, dtype)
    params["head"] = head_init(gen, base, k_classes, dtype)
    return to_device(params, state, device)


def _unit(t):
    return t / torch.clamp_min(torch.linalg.vector_norm(
        t, dim=-1, keepdim=True), 1e-6)


def infoseg_forward(params, state, x, *, train: bool = False,
                    policy: Policy = DEFAULT):
    """InfoSeg on [N, H, W, C]; returns (InfoSegOut, new_state)."""
    feats, ns = trunk_features(params, state, x, train=train, policy=policy)
    logits = dense32(feats, params["head"])                 # [N, H, W, K]
    probs = torch.softmax(logits, dim=-1)
    # class-pooled globals: G[n, k] = sum_x P F / sum_x P
    mass = torch.sum(probs, dim=(1, 2))                     # [N, K]
    glob = (torch.einsum("nhwk,nhwd->nkd", probs, feats)
            / torch.clamp_min(mass, 1e-6)[..., None])       # [N, K, D]
    fh, gh = _unit(feats), _unit(glob)
    scores = torch.einsum("nhwd,nkd->nhwk", fh, gh) / TAU
    return InfoSegOut(logits, scores, probs, fh, gh), ns


def get_label(v: torch.Tensor) -> torch.Tensor:
    """Argmax class map of the probabilities (the reference's
    ``get_label(V)``)."""
    return torch.argmax(v, dim=-1).to(torch.int32)


def compute_infoseg_loss(out: InfoSegOut):
    """The Jensen-Shannon MI bound and the marginal-entropy guard.
    Positives: each pixel against its own image's class features,
    weighted by its soft assignment; negatives: against every other
    image's class features (none at batch 1)."""
    fh, gh, probs = out.feats, out.glob, out.probs
    n, h, w, _ = fh.shape
    k = gh.shape[1]
    sim = torch.einsum("nhwd,mkd->nhwmk", fh, gh) / TAU
    idx = torch.arange(n, device=fh.device)
    own = sim[idx, :, :, idx]                          # [N, H, W, K]
    pos = torch.sum(probs * own, dim=-1)               # [N, H, W]
    loss_pos = torch.mean(log1pexp(-pos))
    if n > 1:
        neg_mask = (1.0 - torch.eye(n, device=fh.device))[:, None, None, :,
                                                          None]
        loss_neg = (torch.sum(log1pexp(sim) * neg_mask)
                    / (n * h * w * (n - 1) * k))
    else:
        loss_neg = 0.0
    marg = torch.mean(probs, dim=(0, 1, 2))            # [K]
    ent = -torch.sum(marg * torch.log(marg + 1e-9))
    return loss_pos + loss_neg - ENTROPY_W * ent
