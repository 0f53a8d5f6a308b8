"""Exact channel tensor parallelism (``onet_tpu/parallel/tensor.py``).

The channel dimension of every DoubleConv splits over the ``model`` axis
(Megatron's MLP split applied to a conv U-Net):

* conv1 is column-parallel: each rank computes its block of output
  channels from the full input;
* BatchNorm is channel-local; its one collective is the ``data``
  reduction that full-batch statistics need;
* conv2 and the transposed conv are row-parallel: each rank convolves its
  input-channel block, and ``psum_scatter`` sums the partial outputs and
  leaves each rank its channel block;
* pool, ReLU and pad are channel-local; each block boundary gathers the
  channels back (``all_gather``);
* the head reduces over channels: one ``psum`` over ``model`` gives the
  projection logits.

Parameters stay replicated; each rank reads its slices of them, so the
sum of the ranks' gradients over the mesh is the full gradient. Weight-
shared models only, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onet_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.models.onet import is_weight_shared, jsd_loss_pair
from onet_tpu_torch.models.unet import pad_to
from onet_tpu_torch.ops.normalize import complement
from onet_tpu_torch.parallel.collectives import (all_gather, gather_parts,
                                                 psum, psum_scatter)


def _slice_ch(w, dim: int, ax):
    """This rank's channel block of ``w`` along ``dim``."""
    if w.shape[dim] % ax.size:
        raise ValueError(f"{w.shape[dim]} channels do not split over "
                         f"{ax.size} '{MODEL_AXIS}' ranks")
    k = w.shape[dim] // ax.size
    return w.narrow(dim, ax.index * k, k)


def _slice_vec_tree(d, ax):
    return {k: _slice_ch(v, 0, ax) for k, v in d.items()}


def _gather_vec_tree(d, ax):
    """Full-channel BatchNorm state from the ranks' slices."""
    return {k: torch.cat(gather_parts(v, ax, name="bn_state"), dim=0)
            for k, v in d.items()}


def _gather_ch(x, ax):
    """Channel-sharded activation [..., C/T] -> full [..., C]."""
    return all_gather(x, ax, dim=-1)


def _dconv_tp(p, s, x_full, *, ax, bn, train, policy):
    """One DoubleConv, column-parallel conv1 -> row-parallel conv2, on the
    full-channel input. Returns (y [..., Cout/T], full-channel state)."""
    h = L.conv3x3(x_full, _slice_ch(p["conv1"]["w"], 3, ax), policy=policy)
    h, s1 = bn(h, _slice_vec_tree(p["bn1"], ax),
               _slice_vec_tree(s["bn1"], ax), train=train, groups=2)
    h = L.relu(h)
    part = L.conv3x3(h, _slice_ch(p["conv2"]["w"], 2, ax), policy=policy)
    y = psum_scatter(part, ax, dim=3)
    y, s2 = bn(y, _slice_vec_tree(p["bn2"], ax),
               _slice_vec_tree(s["bn2"], ax), train=train, groups=2)
    y = L.relu(y)
    return y, {"bn1": _gather_vec_tree(s1, ax),
               "bn2": _gather_vec_tree(s2, ax)}


def _up_tp(p, s, x_sh, skip_sh, *, ax, bn, train, policy):
    """Up block: row-parallel transposed conv, pad, the gathered
    [skip | up] concat and a DoubleConv, on channel-sharded inputs."""
    w = p["up"]["w"]                                  # [2, 2, Cin, Cin/2]
    part = L._nhwc(F.conv_transpose2d(
        L._nchw(policy.cast_compute(x_sh)),
        policy.cast_compute(_slice_ch(w, 2, ax)).permute(2, 3, 0, 1),
        stride=2))
    u = psum_scatter(part, ax, dim=3)
    u = u + _slice_ch(p["up"]["b"], 0, ax).to(u.dtype)
    u = pad_to(u, skip_sh)
    # gather skip and up apart: a concat of slices would interleave the
    # channel blocks and break conv1's [skip | up] weight layout
    xin = torch.cat([_gather_ch(skip_sh, ax), _gather_ch(u, ax)], dim=-1)
    y, ns = _dconv_tp(p["conv"], s["conv"], xin, ax=ax, bn=bn, train=train,
                      policy=policy)
    return y, {"conv": ns}


def unet_apply_tp(params, state, x2b, *, ax, bn, train: bool,
                  policy: Policy = DEFAULT):
    """The U-Net (models/unet.py::unet_apply) with every DoubleConv
    channel-sharded over ``ax``. ``x2b``: the batch-stacked pair
    [2B, H, W, Cin]. Returns ((local, glob), both [..., base/T], new
    full-channel state)."""
    ns = {}
    x1, ns["inc"] = _dconv_tp(params["inc"], state["inc"], x2b, ax=ax,
                              bn=bn, train=train, policy=policy)
    feats = [x1]
    h = x1
    for i in range(1, 5):
        # pool the shard (4x fewer bytes), then one gather per block
        pooled = L.max_pool_2x2(h)
        h, ns[f"down{i}"] = _dconv_tp(params[f"down{i}"], state[f"down{i}"],
                                      _gather_ch(pooled, ax), ax=ax, bn=bn,
                                      train=train, policy=policy)
        feats.append(h)
    y = feats[4]
    for i in range(1, 5):
        y, ns[f"up{i}"] = _up_tp(params[f"up{i}"], state[f"up{i}"], y,
                                 feats[4 - i], ax=ax, bn=bn, train=train,
                                 policy=policy)
    return (x1, y), ns


def make_tp_train_step(mesh, *, policy: Policy = DEFAULT, bias: float = 0.0):
    """The train step with the batch over ``data`` and conv channels over
    ``model``; signature of train.steps.make_train_step's steps, on the
    global batch. Params, BatchNorm and optimizer trees stay replicated.
    Weight-shared models only."""
    from onet_tpu_torch.train.steps import make_loss_and_grads, with_adam

    ax = mesh.axis(MODEL_AXIS)
    data = mesh.axis(DATA_AXIS)

    def bn(x, p, s, *, train, groups):
        # per-channel sums over 'data' only: the channel axis needs none
        with L.bn_axis(data):
            return L.batch_norm(x, p, s, train=train, groups=groups)

    def objective(p, bnst, x_loc):
        if not is_weight_shared(p):
            raise ValueError("tensor parallelism supports weight-shared "
                             "models only")
        x2b = torch.cat([x_loc, complement(x_loc, bias)], dim=0)
        (loc, glob), new_top = unet_apply_tp(p["top"], bnst["top"], x2b,
                                             ax=ax, bn=bn, train=True,
                                             policy=policy)
        locf = loc.float()
        v = psum(torch.sum(locf * glob.float(), dim=-1), ax)   # [2B, H, W]
        lsum = psum(torch.sum(locf, dim=-1), ax)
        b = x_loc.shape[0]
        vpair = torch.stack([v[:b], v[b:]], dim=-1)
        lpair = torch.stack([lsum[:b], lsum[b:]], dim=-1)
        return (jsd_loss_pair(lpair, torch.softmax(vpair, dim=-1)),
                {"top": new_top})

    return with_adam(make_loss_and_grads(objective, mesh, policy=policy),
                     policy)
