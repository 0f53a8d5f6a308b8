"""IIC baseline: Invariant Information Clustering for segmentation
(``onet_tpu/models/iic.py``).

One of the reference config's four model families ("Onet, Infoseg, IIC
and supervised Unet"); its module is absent from the reference, and the
JAX package rebuilt the published method (Ji, Henriques & Vedaldi 2019,
the segmentation variant). Two views of each frame, the original and a
flipped / shifted / intensity-jittered copy, go through one per-pixel
K-way softmax head; the second view's assignment maps are inverted back
onto the first's pixels; the K x K joint over batch, pixels and a
(2r+1)^2 displacement window is accumulated, and its mutual information
maximized. An overclustering head (K_aux > K) trains beside it and is not
used at inference.

The trunk is the InfoSeg baseline's two-scale FCN (``models/infoseg.py``):
two 3x3 conv -> BN -> ReLU at full resolution, a 2x2 max pool, two more at
half resolution, a nearest 2x upsample (edge rows repeated for odd sides)
projected to the full-resolution width and added. Convs and BatchNorm are
``models/layers.py``'s (one statistics group); the heads run in float32.

The random view is split in two: ``iic_pair_from(x, meta, gain)`` applies
given draws deterministically, and ``iic_pair_transform(gen, x)`` draws
them from a ``torch.Generator`` on the data's device (the JAX function
draws from a key, so the two packages draw different views; tests carry
JAX's draws across through ``iic_pair_from``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from onet_tpu_torch.core.device import resolve_device
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.models.unet import tree_map

# IIC eq. (3): I_lambda(P) = sum_ij P_ij (log P_ij - lam log Pi - lam log Pj);
# lam = 1 is plain mutual information, the published default.
LAMBDA = 1.0
EPS = 1e-9


class IICOut(NamedTuple):
    probs: torch.Tensor      # [N, H, W, K] main-head soft assignment
    probs_aux: torch.Tensor  # [N, H, W, K_aux] overclustering head


# ---------------------------------------------------------------------------
# the two-scale trunk (shared with models/infoseg.py)
# ---------------------------------------------------------------------------

TRUNK = (("enc1", "in", 1), ("enc2", 1, 1), ("ctx1", 1, 2), ("ctx2", 2, 2))


def trunk_init(gen: torch.Generator, in_channels: int, base: int, dtype):
    """The four conv -> BN layers and the context projection, drawn on
    the CPU from ``gen``: (params, state)."""
    params, state = {}, {}
    for name, cin, cout in TRUNK:
        cin = in_channels if cin == "in" else cin * base
        params[name] = {"w": L.kaiming_normal_conv(gen, 3, 3, cin,
                                                   cout * base, dtype)}
        params[f"{name}_bn"], state[f"{name}_bn"] = L.bn_init(cout * base,
                                                              dtype)
    params["proj"] = head_init(gen, 2 * base, base, dtype)
    return params, state


def head_init(gen: torch.Generator, din: int, dout: int, dtype):
    """A 1x1 layer, He-normal weights and a zero bias."""
    return {"w": torch.randn((din, dout), generator=gen, dtype=dtype)
            * math.sqrt(2.0 / din),
            "b": torch.zeros((dout,), dtype=dtype)}


def to_device(params, state, device):
    dev = resolve_device(device)
    to = lambda t: t.to(dev)   # noqa: E731
    return tree_map(to, params), tree_map(to, state)


def _conv_bn_relu(x, w, bn_p, bn_s, *, train, policy):
    y = L.conv3x3(x, w["w"], policy=policy)
    y, ns = L.batch_norm(y, bn_p, bn_s, train=train)
    return L.relu(y), ns


def dense32(x, p):
    """x @ w + b in float32."""
    return x.float() @ p["w"].float() + p["b"].float()


def trunk_features(params, state, x, *, train: bool, policy: Policy):
    """[N, H, W, C] -> (float32 features [N, H, W, base], new BN state):
    the full-resolution features plus the projected half-resolution
    context."""
    ns = dict(state)
    y = x
    for name in ("enc1", "enc2"):
        y, ns[f"{name}_bn"] = _conv_bn_relu(
            y, params[name], params[f"{name}_bn"], state[f"{name}_bn"],
            train=train, policy=policy)
    h, w = y.shape[1], y.shape[2]
    c = L.max_pool_2x2(y[:, :h // 2 * 2, :w // 2 * 2])
    for name in ("ctx1", "ctx2"):
        c, ns[f"{name}_bn"] = _conv_bn_relu(
            c, params[name], params[f"{name}_bn"], state[f"{name}_bn"],
            train=train, policy=policy)
    # nearest 2x upsample; an odd side repeats the last row (column)
    rows = torch.clamp(torch.arange(h, device=c.device) // 2,
                       max=c.shape[1] - 1)
    cols = torch.clamp(torch.arange(w, device=c.device) // 2,
                       max=c.shape[2] - 1)
    c = c[:, rows][:, :, cols]
    return y.float() + dense32(c, params["proj"]), ns


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------

def iic_init(gen: torch.Generator, in_channels: int = 1, k_classes: int = 2,
             *, k_aux: int = 6, base: int = 64, dtype=torch.float32,
             device=None):
    """(params, state) of the trunk and the main and overclustering heads,
    drawn on the CPU from ``gen``, on ``device`` (default: the card)."""
    params, state = trunk_init(gen, in_channels, base, dtype)
    params["head"] = head_init(gen, base, k_classes, dtype)
    params["head_aux"] = head_init(gen, base, k_aux, dtype)
    return to_device(params, state, device)


def iic_forward(params, state, x, *, train: bool = False,
                policy: Policy = DEFAULT):
    """IIC on [N, H, W, C]; returns (IICOut, new_state)."""
    feats, ns = trunk_features(params, state, x, train=train, policy=policy)
    probs = torch.softmax(dense32(feats, params["head"]), dim=-1)
    probs_aux = torch.softmax(dense32(feats, params["head_aux"]), dim=-1)
    return IICOut(probs, probs_aux), ns


def get_label(probs: torch.Tensor) -> torch.Tensor:
    """Argmax class map of the main head."""
    return torch.argmax(probs, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# paired views: flips, an integer shift and an intensity gain, and g^-1
# ---------------------------------------------------------------------------

class PairMeta(NamedTuple):
    flip_h: torch.Tensor   # [N] bool (flips W)
    flip_v: torch.Tensor   # [N] bool (flips H)
    dy: torch.Tensor       # [N] int in [-max_shift, max_shift]
    dx: torch.Tensor       # [N] int


def _flip(t, fh, fv):
    """Per-sample flips of [N, H, W, ...]: W where ``fh``, then H where
    ``fv``."""
    sel = (-1,) + (1,) * (t.dim() - 1)
    t = torch.where(fh.reshape(sel), t.flip(2), t)
    return torch.where(fv.reshape(sel), t.flip(1), t)


def iic_pair_from(x, meta: PairMeta, gain):
    """The view g(x) for given draws: per-sample flips (W, then H), a shift
    by (dy, dx) with zero fill (``x2[r, c] = x[r - dy, c - dx]``) and the
    intensity gain ``gain`` ([N], multiplicative), clipped to [0, 1]."""
    n, h, w = x.shape[:3]
    img = _flip(x, meta.flip_h, meta.flip_v)
    dev = x.device
    r = torch.arange(h, device=dev)[None] - meta.dy.to(dev)[:, None]
    c = torch.arange(w, device=dev)[None] - meta.dx.to(dev)[:, None]
    valid = (((r >= 0) & (r < h))[:, :, None]
             & ((c >= 0) & (c < w))[:, None, :])
    out = img[torch.arange(n, device=dev)[:, None, None],
              r.clamp(0, h - 1)[:, :, None], c.clamp(0, w - 1)[:, None, :]]
    out = out * valid[..., None].to(out.dtype)
    g = gain.to(out.dtype).reshape(n, 1, 1, 1)
    return torch.clamp(out * g, 0.0, 1.0)


def iic_pair_transform(gen: torch.Generator, x, *, max_shift: int = 2,
                       gain: float = 0.2):
    """Draw a view pair's transform from ``gen`` (on x's device): flips
    with probability 1/2 each, shifts uniform in [-max_shift, max_shift],
    gains uniform in [1 - gain, 1 + gain]. Returns (g(x), meta)."""
    n, s, dev = x.shape[0], int(max_shift), x.device
    meta = PairMeta(
        torch.rand((n,), generator=gen, device=dev) < 0.5,
        torch.rand((n,), generator=gen, device=dev) < 0.5,
        torch.randint(-s, s + 1, (n,), generator=gen, device=dev),
        torch.randint(-s, s + 1, (n,), generator=gen, device=dev))
    g = 1.0 + gain * (2.0 * torch.rand((n,), generator=gen, device=dev)
                      - 1.0)
    return iic_pair_from(x, meta, g), meta


def iic_undo_geometry(probs2, meta: PairMeta):
    """g^-1 on the transformed view's maps [N, H, W, K] and the validity
    mask [N, H, W, 1] of the pixels that saw real content in both views:
    aligned pixel u faces view-2 pixel u + (dy, dx), valid for
    u in [max(-dy, 0), h - max(dy, 0)); then the flips, in reverse order,
    on the maps and the mask alike."""
    n, h, w = probs2.shape[:3]
    dev = probs2.device
    dy, dx = meta.dy.to(dev), meta.dx.to(dev)
    rows = torch.arange(h, device=dev)[None]
    cols = torch.arange(w, device=dev)[None]
    p = probs2[torch.arange(n, device=dev)[:, None, None],
               ((rows + dy[:, None]) % h)[:, :, None],
               ((cols + dx[:, None]) % w)[:, None, :]]
    vr = (rows >= torch.clamp_min(-dy, 0)[:, None]) & (
        rows < h - torch.clamp_min(dy, 0)[:, None])
    vc = (cols >= torch.clamp_min(-dx, 0)[:, None]) & (
        cols < w - torch.clamp_min(dx, 0)[:, None])
    m = (vr[:, :, None] & vc[:, None, :]).to(torch.float32)
    fh, fv = meta.flip_h.to(dev), meta.flip_v.to(dev)
    sel = (-1, 1, 1, 1)
    p = torch.where(fv.reshape(sel), p.flip(1), p)
    p = torch.where(fh.reshape(sel), p.flip(2), p)
    m = torch.where(fv.reshape(-1, 1, 1), m.flip(1), m)
    m = torch.where(fh.reshape(-1, 1, 1), m.flip(2), m)
    return p, m[..., None]


# ---------------------------------------------------------------------------
# loss: displacement-window joint and mutual information (IIC eq. (3)/(5))
# ---------------------------------------------------------------------------

def _shift_valid(h, w, dy: int, dx: int, device):
    """[1, H, W, 1] mask of the pixels whose roll by (dy, dx) did not
    wrap."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    vr = (rows >= max(dy, 0)) & (rows < h + min(dy, 0))
    vc = (cols >= max(dx, 0)) & (cols < w + min(dx, 0))
    return (vr & vc).to(torch.float32)[None, :, :, None]


def iic_joint(p1, p2, mask, *, radius: int = 1):
    """The K x K' joint: the sum over batch, pixels and the displacement
    window [-r, r]^2 of p1[u] (x) p2[u + t], validity-masked, normalized."""
    h, w = p1.shape[1], p1.shape[2]
    joint = torch.zeros((p1.shape[-1], p2.shape[-1]), dtype=torch.float32,
                        device=p1.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            p2s = torch.roll(p2, (dy, dx), dims=(1, 2))
            m2s = torch.roll(mask, (dy, dx), dims=(1, 2))
            wgt = m2s * _shift_valid(h, w, dy, dx, p1.device)
            joint = joint + torch.einsum("nhwk,nhwl->kl", p1 * wgt, p2s)
    return joint / torch.clamp_min(torch.sum(joint), EPS)


def mutual_information(joint, *, lam: float = LAMBDA):
    """I_lambda of a normalized joint; a square joint is symmetrized
    first."""
    if joint.shape[0] == joint.shape[1]:
        joint = (joint + joint.T) / 2.0
    pi = torch.sum(joint, dim=1, keepdim=True)
    pj = torch.sum(joint, dim=0, keepdim=True)
    return torch.sum(joint * (torch.log(joint + EPS)
                              - lam * torch.log(pi + EPS)
                              - lam * torch.log(pj + EPS)))


def compute_iic_loss(out1: IICOut, out2_aligned: IICOut, mask, *,
                     radius: int = 1, lam: float = LAMBDA,
                     aux_weight: float = 1.0):
    """-I(main) - aux_weight * I(aux), both heads on the same view pair."""
    main = mutual_information(
        iic_joint(out1.probs, out2_aligned.probs, mask, radius=radius),
        lam=lam)
    aux = mutual_information(
        iic_joint(out1.probs_aux, out2_aligned.probs_aux, mask,
                  radius=radius), lam=lam)
    return -(main + aux_weight * aux)


def iic_pair_loss(params, state, x, x2, meta: PairMeta, *, policy: Policy,
                  radius: int = 1, lam: float = LAMBDA):
    """The train step's objective on one view pair: both views in one
    [2N] forward (shared BN statistics), the second view's maps inverted,
    the IIC loss. Returns (loss, new_state)."""
    out, ns = iic_forward(params, state, torch.cat([x, x2]), train=True,
                          policy=policy)
    n = x.shape[0]
    out1 = IICOut(out.probs[:n], out.probs_aux[:n])
    p2, mask = iic_undo_geometry(out.probs[n:], meta)
    p2a, _ = iic_undo_geometry(out.probs_aux[n:], meta)
    return compute_iic_loss(out1, IICOut(p2, p2a), mask, radius=radius,
                            lam=lam), ns
