"""Train and eval steps (``onet_tpu/train/steps.py``).

One step: forward (the fused complementary twin pass) -> JSD loss ->
gradients -> Adam. PyTorch runs it eagerly, so the builders return plain
callables where the JAX package returns jitted functions. The params and
the optimizer state are updated in place (the JAX step donates their
buffers); the new BatchNorm state comes back as a new tree. Each step runs
under its policy's precision switches, backward included.

``make_grad_step`` builds such a step from any objective (the supervised
ZY-3 step's, the baselines'). ``quantized`` ("fwd" or "fwd+dx") runs the 3x3 convs in int8
(``models/qtrain.py``) on the stacked graph. ``forward`` swaps in another
backbone family's forward (``models/arch.py``); the conv-specific options
(``quantized``, ``spatial``) apply to the vanilla conv U-Net only.

``mesh`` (``core/mesh.py``) makes the step data parallel over the mesh's
``data`` axis: every rank calls it with the same global batch, runs its
block of rows, and the BatchNorm statistics, the loss and the gradients
are reduced over the mesh, so every rank applies the same Adam update and
holds the same parameters, optimizer state and BatchNorm state, equal to
the single-device step on the global batch. ``spatial=True`` on a mesh
with a ``space`` axis also splits image rows (and ``spacew`` columns) by
exact halo exchange (``parallel/halo.py``); the JAX package's GSPMD
spatial step, whose backward is approximate by its own account, is not
reproduced. JAX's ``reshard`` hook has no counterpart in a
multi-process program.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.mesh import (DATA_AXIS, SPACE_AXIS, SPACEW_AXIS,
                                      batch_sharding)
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.metrics.segmentation import (
    align_labels_by_accuracy, align_labels_hungarian,
    evaluate_binary_segmentation)
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.models.onet import (LOSSES, compute_loss_rsn,
                                        onet_forward, predict_label)
from onet_tpu_torch.models.unet import (DEFAULT_OPS, tree_leaves, tree_map,
                                        tree_unflatten)
from onet_tpu_torch.parallel.collectives import (all_reduce_flat,
                                                 gather_parts)
from onet_tpu_torch.train.optim import adam_update


def make_loss_and_grads(objective, mesh=None, *, policy: Policy = DEFAULT,
                        spatial: bool = False, microbatches: int = 1,
                        check=None):
    """``loss_and_grads(params, state, x, *extra) -> (loss, new_state,
    grads)`` for ``objective(params, state, x, *extra) -> (loss,
    new_state)``, under the policy's precision: the one place where a
    step's loss and gradient are formed and reduced.

    With ``mesh`` every rank takes the global batch ``x`` (and every
    ``extra`` tensor, e.g. labels) and the objective runs on its block
    (rows over ``data``; with ``spatial``, image rows over ``space`` and
    columns over ``spacew``). BatchNorm statistics reduce over the sharded
    axes; the loss is the mean of the ranks' losses and the gradient their
    sum's, all-reduced as one flat buffer, so every rank holds the
    single-device step's loss and gradient on the global batch.
    ``microbatches`` cuts the batch into that many slices run one after
    the other (statistics per slice), their losses and gradients averaged.
    ``check(x)`` validates the batch."""
    if mesh is None:
        cut, bn_ax, world, size = (lambda t: t), None, None, 1
    else:
        cut = batch_sharding(mesh, spatial=spatial).local
        bn_ax = mesh.axis((DATA_AXIS, SPACE_AXIS, SPACEW_AXIS) if spatial
                          else (DATA_AXIS,))
        world, size = mesh.world, mesh.size

    def slices(t):
        if microbatches == 1:
            return [t]
        n = t.shape[0]
        if n % microbatches:
            raise ValueError(f"batch {n} not divisible by {microbatches} "
                             f"microbatches")
        return t.reshape(microbatches, n // microbatches, *t.shape[1:])

    def loss_and_grads(params, state, x, *extra):
        if check is not None:
            check(x)
        with policy.precision():
            new_state, gsum, vsum = state, None, None
            for xb, *eb in zip(slices(x), *map(slices, extra)):
                p = tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
                with torch.enable_grad(), L.bn_axis(bn_ax):
                    value, new_state = objective(p, new_state, cut(xb),
                                                 *map(cut, eb))
                    g = torch.autograd.grad(value, tree_leaves(p))
                value = value.detach()
                gsum = list(g) if gsum is None else [
                    a + b for a, b in zip(gsum, g)]
                vsum = value if vsum is None else vsum + value
            flat = all_reduce_flat(gsum + [vsum.reshape(1)], world,
                                   scale=1.0 / (size * microbatches),
                                   name="grads")
        return flat[-1].reshape(()), new_state, tree_unflatten(params,
                                                               flat[:-1])

    return loss_and_grads


def with_adam(loss_and_grads, policy: Policy):
    """The train step (params, state, opt_state, x, *extra, lr) ->
    (params, new state, opt_state, loss) around ``loss_and_grads(params,
    state, x, *extra) -> (loss, new_state, grads)``: Adam in place, under
    the policy's precision. The step keeps ``loss_and_grads`` as an
    attribute."""
    def train_step(params, state, opt_state, x, *extra_and_lr):
        *extra, lr = extra_and_lr
        value, new_state, grads = loss_and_grads(params, state, x, *extra)
        with policy.precision():
            updates, opt_state = adam_update(grads, opt_state, lr)
            with torch.no_grad():
                torch._foreach_add_(tree_leaves(params),
                                    tree_leaves(updates))
        return params, new_state, opt_state, value

    train_step.loss_and_grads = loss_and_grads
    return train_step


def make_grad_step(loss_fn, policy: Policy, *, mesh=None):
    """A train step from an objective: ``loss_fn(params, state, x, *extra)
    -> (loss, new_state)``; the step is (params, state, opt_state, x,
    *extra, lr) -> (params, new_state, opt_state, loss), Adam applied in
    place, under the policy's precision. With ``mesh``, data parallel over
    its ``data`` axis on the global ``x`` and ``extra``
    (``make_loss_and_grads``)."""
    return with_adam(make_loss_and_grads(loss_fn, mesh, policy=policy),
                     policy)


def _mesh_loss(loss: str, mesh):
    """The objective on this rank's rows: ``rsn`` rolls the global batch
    (one ppermute over ``data``)."""
    if loss == "rsn" and mesh is not None:
        data = mesh.axis(DATA_AXIS)
        return lambda out: compute_loss_rsn(out, batch_axis=data)
    return LOSSES[loss]


def onet_objective(mesh=None, *, policy: Policy = DEFAULT, bias: float = 0.0,
                   ops=DEFAULT_OPS, loss: str = "jsd", forward=None):
    """The Onet objective on this rank's block, ``(params, bn_state, x) ->
    (loss, new_bn)``: the fused twin pass with the layer ``ops`` (or
    another family's ``forward``) and the named loss."""
    loss_of = _mesh_loss(loss, mesh)
    custom = forward is not None and forward is not onet_forward

    def objective(params, bn_state, x):
        if custom:
            out, new_bn = forward(params, bn_state, x, train=True,
                                  bias=bias, policy=policy)
        else:
            out, new_bn = onet_forward(params, bn_state, x, train=True,
                                       bias=bias, policy=policy, ops=ops)
        return loss_of(out), new_bn

    return objective


def make_train_step(*, policy: Policy = DEFAULT, bias: float = 0.0,
                    mesh=None, spatial: bool = False, microbatches: int = 1,
                    quantized: str = None, forward=None, loss: str = "jsd"):
    """Build the train step:
    (params, bn_state, opt_state, x, lr) -> (params, bn_state, opt_state,
    loss).

    ``microbatches=k`` accumulates the gradients of k sequential slices of
    the batch before one Adam update; the loss and gradient are their
    means, and the BatchNorm state threads through the slices in order.
    ``loss``: "jsd" (the reference objective) or "rsn" (random-sampling
    negatives). ``quantized`` (None: exact): "fwd" runs the 3x3 convs
    with int8 forward arithmetic, "fwd+dx" also the input-gradient convs
    (``models/qtrain.py``), on the vanilla backbone only. ``forward``
    (``models/arch.py``): another family's forward, with onet_forward's
    signature. ``mesh``: data parallel (``make_loss_and_grads``); with
    ``spatial`` and a ``space`` axis, exact halo-exchange spatial
    partitioning as well (``parallel/halo.py``), exact arithmetic only.
    Without a mesh ``spatial`` changes nothing, as in the JAX package."""
    custom = forward is not None and forward is not onet_forward
    if custom and (quantized or spatial):
        raise ValueError("quantized / spatial training applies to the "
                         "vanilla conv backbone only")
    if quantized:
        from onet_tpu_torch.models.qtrain import make_qtrain_ops
        ops = make_qtrain_ops(level=quantized)
    else:
        ops = DEFAULT_OPS
    if mesh is not None and spatial and SPACE_AXIS in mesh.axis_names:
        from onet_tpu_torch.parallel.halo import make_spatial_train_step
        return make_spatial_train_step(mesh, policy=policy, bias=bias,
                                       loss=loss, microbatches=microbatches,
                                       quantized=quantized)
    objective = onet_objective(mesh, policy=policy, bias=bias, ops=ops,
                               loss=loss, forward=forward)
    return with_adam(make_loss_and_grads(objective, mesh, policy=policy,
                                         microbatches=microbatches), policy)


def _gather_pred(pred, mesh, spatial: bool):
    """This rank's [b, h, w] labels -> the global batch's, in order."""
    axes = ((SPACEW_AXIS, 2), (SPACE_AXIS, 1)) if spatial else ()
    for name, dim in axes + ((DATA_AXIS, 0),):
        pred = torch.cat(gather_parts(pred, mesh.axis(name)), dim=dim)
    return pred


def make_eval_step(*, policy: Policy = DEFAULT, bias: float = 0.0,
                   align: str = "flip", mesh=None, spatial: bool = False,
                   forward=None, loss: str = "jsd"):
    """Build the eval step: (params, bn_state, x, labels) -> (metrics,
    loss, pred). ``align``: 'flip' (the accuracy flip test), 'hungarian'
    (K=2 keep-or-swap) or 'none' (raw argmax). ``forward``: another
    family's forward (``models/arch.py``). With ``mesh`` each rank runs
    its rows of the global batch (``spatial``: its image block, halo
    convs), the predictions are gathered and the metrics computed on the
    global batch, equal to the single-device step's."""
    fwd = forward or onet_forward
    if align not in ("flip", "hungarian", "none"):
        raise ValueError(f"align must be flip, hungarian or none, not "
                         f"{align!r}")
    custom = forward not in (None, onet_forward)
    sp = (mesh is not None and spatial and not custom
          and SPACE_AXIS in mesh.axis_names)
    kw = {}
    if mesh is None:
        loss_of = LOSSES[loss]
    else:
        loss_of = _mesh_loss(loss, mesh)
        shard = batch_sharding(mesh, spatial=sp)
        if sp:
            from onet_tpu_torch.parallel.halo import make_halo_ops
            kw["ops"] = make_halo_ops(mesh.shape[SPACE_AXIS],
                                      mesh.shape.get(SPACEW_AXIS, 1),
                                      mesh=mesh)

    def eval_step(params, bn_state, x, labels):
        with torch.no_grad(), policy.precision():
            xl = x if mesh is None else shard.local(x)
            out, _ = fwd(params, bn_state, xl, train=False, bias=bias,
                         policy=policy, **kw)
            value = loss_of(out)
            pred = predict_label(out.S)
            if mesh is not None:
                pred = _gather_pred(pred, mesh, sp)
                value = all_reduce_flat([value.reshape(1)], mesh.world,
                                        scale=1.0 / mesh.size)[0][0]
            if align == "flip":
                pred = align_labels_by_accuracy(pred, labels)
            elif align == "hungarian":
                pred = align_labels_hungarian(pred, labels)
            return evaluate_binary_segmentation(pred, labels), value, pred

    return eval_step
