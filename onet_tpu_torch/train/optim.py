"""Optimizer and LR schedules (``onet_tpu/train/optim.py``).

Adam as ``optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0)`` with
the learning rate applied outside, per step: torch.optim.Adam's defaults,
the reference's optimizer. The state is a dict of ``count`` (int32 scalar),
``mu`` and ``nu`` (trees like the params). ``adam_update`` updates the state
in place under ``no_grad`` and returns the updates; the JAX package donates
the same buffers to its jitted step for the same effect.
"""

from __future__ import annotations

import math

import torch

from onet_tpu_torch.models.unet import tree_leaves, tree_map, tree_unflatten

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_init(params):
    return {"count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params)),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def _device(tree):
    return tree_leaves(tree)[0].device


def adam_update(grads, opt_state, lr):
    """One Adam step: updates -lr * mu_hat / (sqrt(nu_hat) + eps), in the
    order of optax's arithmetic. ``opt_state`` is updated in place (and
    returned).

    Each line of the arithmetic is one ``torch._foreach_*`` call over all
    leaves (a few launches, where one op a leaf made thousands), and the
    bias corrections are formed on the state's device, so the update never
    waits for the device: the host launches it while the backward pass
    still runs."""
    with torch.no_grad():
        count = opt_state["count"]
        count.add_(1)
        c = count.to(torch.float32)
        bc1 = 1 - torch.full_like(c, B1) ** c
        bc2 = 1 - torch.full_like(c, B2) ** c
        g = tree_leaves(grads)
        m, v = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        torch._foreach_mul_(m, B1)                 # (1-b1) g + b1 m
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - B1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - B2)
        torch._foreach_mul_(v, B2)
        torch._foreach_add_(v, g2)
        del g2
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        out = torch._foreach_div(m, bc1)
        torch._foreach_div_(out, den)
        del den
        torch._foreach_mul_(out, -lr)
        updates = tree_unflatten(grads, out)
    return updates, opt_state


def step_decay(base_lr: float, epoch: int, *, every: int = 100,
               factor: float = 0.5) -> float:
    """lr *= factor at each multiple of ``every`` (the reference's
    simclutter schedule)."""
    return base_lr * factor ** (epoch // every)


def cosine_warm_restarts(base_lr: float, epoch: int, *, t0: int = 300,
                         t_mult: int = 2, eta_min: float = 1e-6) -> float:
    """torch CosineAnnealingWarmRestarts, stepped per epoch (the
    reference's zy3 schedule)."""
    t_cur, t_i = epoch, t0
    while t_cur >= t_i:
        t_cur -= t_i
        t_i *= t_mult
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * t_cur / t_i)) / 2


def freeze_params(grads, frozen_fn):
    """Zero the gradient of frozen leaves: ``frozen_fn(path) -> bool``
    with ``path`` the tuple of dict keys and list indices (as strings) from
    the root."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return torch.zeros_like(tree) if frozen_fn(path) else tree

    return walk(grads, ())
