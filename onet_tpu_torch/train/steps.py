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
(``quantized``) apply to the vanilla conv U-Net only. Not ported here:
``mesh`` and ``spatial`` (data and spatial parallelism, ROADMAP.md Queue A
item 4); they raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.metrics.segmentation import (
    align_labels_by_accuracy, align_labels_hungarian,
    evaluate_binary_segmentation)
from onet_tpu_torch.models.onet import LOSSES, onet_forward, predict_label
from onet_tpu_torch.models.unet import (DEFAULT_OPS, tree_leaves, tree_map,
                                        tree_unflatten)
from onet_tpu_torch.train.optim import adam_update


def _not_ported(**opts):
    given = sorted(k for k, v in opts.items() if v)
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not in the port yet (data, spatial and "
            f"pipeline parallelism: ROADMAP.md, Queue A item 4)")


def make_grad_step(loss_fn, policy: Policy):
    """A train step from an objective: ``loss_fn(params, state, x, *extra)
    -> (loss, new_state)``; the step is (params, state, opt_state, x,
    *extra, lr) -> (params, new_state, opt_state, loss), Adam applied in
    place, under the policy's precision."""
    def step(params, state, opt_state, x, *extra_and_lr):
        *extra, lr = extra_and_lr
        with policy.precision():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            with torch.enable_grad():
                loss, new_state = loss_fn(p, state, x, *extra)
            grads = torch.autograd.grad(loss, tree_leaves(p))
            updates, opt_state = adam_update(tree_unflatten(params, grads),
                                             opt_state, lr)
            with torch.no_grad():
                tree_map(lambda t, u: t.add_(u), params, updates)
        return params, new_state, opt_state, loss.detach()

    return step


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
    signature."""
    custom = forward is not None and forward is not onet_forward
    if custom and quantized:
        raise ValueError("quantized training applies to the vanilla conv "
                         "backbone only")
    _not_ported(mesh=mesh, spatial=spatial)
    if quantized:
        from onet_tpu_torch.models.qtrain import make_qtrain_ops
        ops = make_qtrain_ops(level=quantized)
    else:
        ops = DEFAULT_OPS
    loss_of = LOSSES[loss]

    def grads_of(params, bn_state, x):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            if custom:
                out, new_bn = forward(p, bn_state, x, train=True, bias=bias,
                                      policy=policy)
            else:
                out, new_bn = onet_forward(p, bn_state, x, train=True,
                                           bias=bias, policy=policy, ops=ops)
            value = loss_of(out)
        grads = torch.autograd.grad(value, tree_leaves(p))
        return value.detach(), new_bn, tree_unflatten(params, grads)

    def train_step(params, bn_state, opt_state, x, lr):
        with policy.precision():
            if microbatches == 1:
                value, new_bn, grads = grads_of(params, bn_state, x)
            else:
                n = x.shape[0]
                if n % microbatches:
                    raise ValueError(f"batch {n} not divisible by "
                                     f"{microbatches} microbatches")
                new_bn, gsum, value = bn_state, None, 0.0
                for xb in x.reshape(microbatches, n // microbatches,
                                    *x.shape[1:]):
                    v, new_bn, g = grads_of(params, new_bn, xb)
                    gsum = g if gsum is None else tree_map(torch.add, gsum,
                                                           g)
                    value = value + v
                grads = tree_map(lambda t: t / microbatches, gsum)
                value = value / microbatches
            updates, opt_state = adam_update(grads, opt_state, lr)
            with torch.no_grad():
                tree_map(lambda t, u: t.add_(u), params, updates)
        return params, new_bn, opt_state, value

    return train_step


def make_eval_step(*, policy: Policy = DEFAULT, bias: float = 0.0,
                   align: str = "flip", mesh=None, spatial: bool = False,
                   forward=None, loss: str = "jsd"):
    """Build the eval step: (params, bn_state, x, labels) -> (metrics,
    loss, pred). ``align``: 'flip' (the accuracy flip test), 'hungarian'
    (K=2 keep-or-swap) or 'none' (raw argmax). ``forward``: another
    family's forward (``models/arch.py``)."""
    _not_ported(mesh=mesh, spatial=spatial)
    fwd = forward or onet_forward
    if align not in ("flip", "hungarian", "none"):
        raise ValueError(f"align must be flip, hungarian or none, not "
                         f"{align!r}")
    loss_of = LOSSES[loss]

    def eval_step(params, bn_state, x, labels):
        with torch.no_grad(), policy.precision():
            out, _ = fwd(params, bn_state, x, train=False, bias=bias,
                         policy=policy)
            value = loss_of(out)
            pred = predict_label(out.S)
            if align == "flip":
                pred = align_labels_by_accuracy(pred, labels)
            elif align == "hungarian":
                pred = align_labels_hungarian(pred, labels)
            return evaluate_binary_segmentation(pred, labels), value, pred

    return eval_step
