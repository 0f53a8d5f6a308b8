"""Exact spatially partitioned training by halo exchange
(``onet_tpu/parallel/halo.py``).

Each rank holds a contiguous block of image rows (``space``) and, on a
2-D spatial mesh, of columns too (``spacew``), for its shard of the batch
(``data``):

* 3x3 SAME conv: one boundary row goes to each row neighbour through
  ``ppermute`` (a global edge receives zeros, the SAME padding), then the
  conv runs VALID in H. In 2-D the column exchange runs on the row-padded
  tensor, so the corner pixels reach the diagonal neighbours in two hops,
  and the conv runs VALID in W as well. Exact for any block height >= 1.
  The conv itself stays ``F.conv2d``: the JAX package computes it with
  ``lax.conv`` outside any Pallas kernel.
* 2x2 stride-2 pool and transposed conv are window-aligned: local (even
  local extents, ``validate_spatial_shapes``).
* BatchNorm reduces its sums over ``data``, ``space`` (and ``spacew``):
  full-batch statistics (``models/layers.py::bn_axis``).
* int8 training (``quantized``): the conv is ``models/qtrain.py``'s int8
  conv on the same halo-padded block, its activation scale the max over
  ``data``, ``space`` and ``spacew`` (zero rows do not move a max), so
  each rank's codes are the one-device step's. That conv pads SAME; the
  rows and columns it computes beyond the VALID extent are cut off, and
  its straight-through backward, on a dy zero there, is the VALID conv's.

The backward is exact too: ``ppermute``'s transpose sends each halo's
cotangent back to the rank the row came from. The JAX package's other
spatial path, GSPMD's partitioning of ``make_train_step(spatial=True)``,
has an approximate backward by its own account; the port does not
reproduce it, and its ``make_train_step(mesh, spatial=True)`` runs these
ops instead.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from onet_tpu_torch.core.mesh import DATA_AXIS, SPACE_AXIS, SPACEW_AXIS
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.parallel.collectives import ppermute


def _exchange_halos(x, axis, dim: int):
    """``x`` padded along ``dim`` with one neighbour slice before and
    after; the global edges receive zeros (SAME padding)."""
    n = 1 if axis is None else axis.size
    if n == 1:
        pad = [0, 0] * (x.dim() - 1 - dim) + [1, 1]
        return F.pad(x, pad)
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    before = ppermute(last, axis, [(i, i + 1) for i in range(n - 1)],
                      name="halo")
    after = ppermute(first, axis, [(i + 1, i) for i in range(n - 1)],
                     name="halo")
    return torch.cat([before, x, after], dim=dim)


def make_halo_ops(n_space: int, n_spacew: int = 1, *, mesh=None,
                  quantized: str = None):
    """Layer-op namespace for ``onet_forward(..., ops=...)`` on this rank's
    block. ``mesh`` (``core/mesh.py``) supplies the axes; without one
    (or with ``n_space = n_spacew = 1``) the ops are the single-device
    layers. BatchNorm reduces over ``data``, ``space`` and ``spacew``.
    ``quantized`` ("fwd" / "fwd+dx"): the convs in int8
    (``models/qtrain.py``)."""
    if mesh is not None:
        if mesh.shape.get(SPACE_AXIS, 1) != n_space or \
                mesh.shape.get(SPACEW_AXIS, 1) != n_spacew:
            raise ValueError(f"mesh {mesh.shape} has not {n_space} x "
                             f"{n_spacew} spatial shards")
    row = None if mesh is None else mesh.axis(SPACE_AXIS)
    col = None if mesh is None else mesh.axis(SPACEW_AXIS)
    bn_ax = None if mesh is None else mesh.axis(
        (DATA_AXIS, SPACE_AXIS, SPACEW_AXIS))

    qconv = None
    if quantized:
        from onet_tpu_torch.models.qtrain import make_qtrain_ops
        qconv = make_qtrain_ops(level=quantized).conv3x3

    def conv3x3(x, w, *, policy: Policy = DEFAULT):
        xp = _exchange_halos(x, row, 1)
        if n_spacew > 1:
            xp = _exchange_halos(xp, col, 2)
            pad_w = 0                        # W covered by halos too
        else:
            pad_w = 1                        # W SAME
        if qconv is not None:
            y = qconv(xp, w, policy=policy)  # SAME: cut to VALID
            y = y[:, 1:-1]
            return (y[:, :, 1:-1] if pad_w == 0 else y).contiguous()
        y = F.conv2d(L._nchw(policy.cast_compute(xp)),
                     policy.cast_compute(w).permute(3, 2, 0, 1),
                     padding=(0, pad_w))     # H covered by halos
        return L._nhwc(y)

    def batch_norm(x, params, state, *, train: bool, groups: int = 1,
                   momentum: float = L.BN_MOMENTUM, eps: float = L.BN_EPS,
                   stacked: bool = False, interleaved: bool = False):
        with L.bn_axis(bn_ax):
            return L.batch_norm(x, params, state, train=train,
                                groups=groups, momentum=momentum, eps=eps,
                                stacked=stacked, interleaved=interleaved)

    return types.SimpleNamespace(
        conv3x3=conv3x3,
        batch_norm=batch_norm,
        max_pool=L.max_pool_2x2,              # window-aligned: local
        conv_transpose=L.conv_transpose_2x2,  # stride == kernel: local
    )


def validate_spatial_shapes(h: int, n_space: int, levels: int = 4,
                            w: int = None, n_spacew: int = 1):
    """Every maxpool needs an even local extent: H % (2^levels * n_space)
    (and W % (2^levels * n_spacew) on a 2-D spatial mesh)."""
    if h % ((2 ** levels) * n_space):
        raise ValueError(
            f"height {h} not divisible by {(2 ** levels) * n_space} "
            f"(= 2^{levels} pool levels x {n_space} spatial shards)")
    if n_spacew > 1 and (w or h) % ((2 ** levels) * n_spacew):
        raise ValueError(
            f"width {w or h} not divisible by {(2 ** levels) * n_spacew} "
            f"(= 2^{levels} pool levels x {n_spacew} width shards)")


def make_spatial_train_step(mesh, *, policy: Policy = DEFAULT,
                            bias: float = 0.0, loss: str = "jsd",
                            microbatches: int = 1, quantized: str = None):
    """The train step with the batch over ``data`` and image rows over
    ``space`` (columns over ``spacew`` where the mesh has it): exact
    gradients by halo exchange. Signature of train.steps.make_train_step's
    steps: (params, bn_state, opt_state, x, lr) on the global batch. The
    twin branches take ``onet_forward``'s default layout, as the
    data-parallel step's do. ``quantized``: int8 convs (``make_halo_ops``),
    equal to the one-device int8 step on the global batch."""
    from onet_tpu_torch.train.steps import make_loss_and_grads, \
        onet_objective, with_adam

    n_space = int(mesh.shape.get(SPACE_AXIS, 1))
    n_spacew = int(mesh.shape.get(SPACEW_AXIS, 1))
    ops = make_halo_ops(n_space, n_spacew, mesh=mesh, quantized=quantized)

    def check(x):
        validate_spatial_shapes(x.shape[1], n_space, w=x.shape[2],
                                n_spacew=n_spacew)

    objective = onet_objective(mesh, policy=policy, bias=bias, ops=ops,
                               loss=loss)
    return with_adam(make_loss_and_grads(objective, mesh, policy=policy,
                                         spatial=True,
                                         microbatches=microbatches,
                                         check=check), policy)
