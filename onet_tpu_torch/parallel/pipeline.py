"""Exact pipeline parallelism: a GPipe schedule over the ``stage`` axis
(``onet_tpu/parallel/pipeline.py``).

The U-Net's natural two-stage cut is encoder | decoder: the encoder's
five feature maps (the decoder's skip inputs) are the payload between the
stages. The global batch is cut into M microbatches. Fill then drain:
stage 0 encodes microbatch m and hands its payload to stage 1 through
``ppermute`` (one flat buffer), then encodes m + 1 while stage 1 decodes
m and takes its loss. The backward runs the microbatches in reverse
order: stage 1 differentiates its loss, and ``ppermute``'s transpose
sends the payload's cotangent back to stage 0, which differentiates its
encoder with it. Each microbatch's graph is separate (BatchNorm's running
statistics live outside it), so the two stages meet in one fixed order.

Numerics: BatchNorm statistics are per microbatch (the full batch never
sits at one stage), over the ``data`` axis when the batch is also split
there, and each stage threads its layers' running statistics through the
microbatches in order: the semantics of the single-device step with
``microbatches=M``, which is this step's exactness mate. Each rank holds
gradients for its stage's parameters only; their sum over the mesh is the
full gradient. Each stage's new BatchNorm subtree is then broadcast over
``stage``, so every rank holds the whole state.

Weight-shared models, the jsd objective and exact arithmetic only, as in
the JAX package.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.mesh import DATA_AXIS, STAGE_AXIS
from onet_tpu_torch.core.policy import Policy, DEFAULT
from onet_tpu_torch.models import layers as L
from onet_tpu_torch.models.onet import channel_dot, is_weight_shared, jsd
from onet_tpu_torch.models.unet import (_double_conv, _down, _up,
                                        tree_leaves, tree_map,
                                        tree_unflatten)
from onet_tpu_torch.ops.normalize import complement
from onet_tpu_torch.parallel.collectives import (all_reduce_flat,
                                                 broadcast_, ppermute)
from onet_tpu_torch.train.steps import with_adam

N_STAGES = 2  # encoder | decoder, the U-Net's natural cut

_ENC_KEYS = ("inc", "down1", "down2", "down3", "down4")
_DEC_KEYS = ("up1", "up2", "up3", "up4")


def _encode(p, s, x2b, *, policy):
    """Stage 0: inc + down1..down4 on the batch-stacked pair. Returns the
    five feature maps (the payload) and the encoder's new BN state."""
    ns = {}
    h, ns["inc"] = _double_conv(p["inc"], s["inc"], x2b, train=True,
                                groups=2, policy=policy)
    feats = [h]
    for i in range(1, 5):
        h, ns[f"down{i}"] = _down(p[f"down{i}"], s[f"down{i}"], h,
                                  train=True, groups=2, policy=policy)
        feats.append(h)
    return feats, ns


def _decode_loss(p, s, feats, *, policy):
    """Stage 1: up1..up4, the projection head and the symmetric JSD loss
    on this rank's microbatch shard."""
    ns = {}
    y = feats[4]
    for i in range(1, 5):
        y, ns[f"up{i}"] = _up(p[f"up{i}"], s[f"up{i}"], y, feats[4 - i],
                              train=True, groups=2, policy=policy)
    loc, glob = feats[0], y
    b = loc.shape[0] // 2
    lt, ld = loc[:b].float(), loc[b:].float()
    vt = channel_dot(lt, glob[:b].float())
    vd = channel_dot(ld, glob[b:].float())
    sm = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
    ct, cd = torch.sum(lt, dim=-1), torch.sum(ld, dim=-1)
    loss = -(jsd(ct, sm[..., 0], sm[..., 1])
             + jsd(cd, sm[..., 1], sm[..., 0])) / 2.0
    return loss, ns


def _payload_shapes(b2, h, w, base):
    """The encoder's five outputs."""
    if h % 16 or w % 16:
        raise ValueError(f"pipeline needs H, W divisible by 16, got {h}x{w}")
    c = tuple(base * m for m in (1, 2, 4, 8, 16))
    return tuple((b2, h >> k, w >> k, c[k]) for k in range(5))


def _bn_tree_broadcast(state, keys, stage, src):
    """Broadcast the BN subtree ``keys`` from stage ``src`` (one flat
    buffer); returns the subtree as every rank now holds it."""
    sub = {k: state[k] for k in keys}
    leaves = tree_leaves(sub)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    broadcast_(flat, stage, src, name="bn_state")
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].view_as(t).clone())
        off += t.numel()
    return tree_unflatten(sub, out)


def make_pp_train_step(mesh, *, microbatches: int, policy: Policy = DEFAULT,
                       bias: float = 0.0):
    """The pipelined train step over a ``('data', 'stage')`` mesh, on the
    global batch: (params, bn_state, opt_state, x, lr) -> (params, bn_state,
    opt_state, loss), as train.steps.make_train_step's. The batch is cut
    microbatch-major (global microbatch m is rows [m B/M, (m+1) B/M), of
    which each data shard takes its block), so microbatch m holds the
    frames the single-device ``microbatches=M`` step gives it. The step
    has ``loss_and_grads(params, bn_state, x)``."""
    if int(mesh.shape.get(STAGE_AXIS, 1)) != N_STAGES:
        raise ValueError(f"pipeline mesh needs {N_STAGES} '{STAGE_AXIS}' "
                         f"devices, got {mesh.shape}")
    m_count = int(microbatches)
    if m_count < 1:
        raise ValueError("microbatches must be >= 1")
    stage = mesh.axis(STAGE_AXIS)
    data = mesh.axis(DATA_AXIS)
    world = mesh.world
    first = stage.index == 0
    fwd = [(0, 1)]

    def loss_and_grads(params, bn_state, x):
        if not is_weight_shared(params):
            raise ValueError("pipeline parallelism supports weight-shared "
                             "models only (params must have no 'down' twin)")
        n = x.shape[0]
        if n % m_count or (n // m_count) % data.size:
            raise ValueError(
                f"batch {n} not divisible into {m_count} microbatches of "
                f"{data.size} data shards")
        per = n // m_count // data.size
        xm = x.reshape(m_count, n // m_count, *x.shape[1:])
        xm = xm[:, data.index * per:(data.index + 1) * per]
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        top = p["top"]
        base = top["inc"]["conv1"]["w"].shape[-1]
        shapes = _payload_shapes(2 * per, x.shape[1], x.shape[2], base)
        sizes = [a * b * c * d for a, b, c, d in shapes]
        cdt = policy.compute_dtype
        bn = dict(bn_state["top"])
        sent, recvd, losses = [], [], []
        with policy.precision():
            with torch.enable_grad(), L.bn_axis(data):
                for m in range(m_count):
                    if first:
                        x2b = torch.cat([xm[m], complement(xm[m], bias)])
                        feats, ns = _encode(top, bn, x2b, policy=policy)
                        bn.update(ns)
                        payload = torch.cat([f.reshape(-1) for f in feats])
                    else:
                        payload = torch.zeros(sum(sizes), dtype=cdt,
                                              device=x.device,
                                              requires_grad=True)
                    recv = ppermute(payload, stage, fwd,
                                    name="stage_activations")
                    if not first:
                        feats = [t.view(sh) for t, sh in
                                 zip(recv.split(sizes), shapes)]
                        loss_m, ns = _decode_loss(top, bn, feats,
                                                  policy=policy)
                        bn.update(ns)
                        losses.append(loss_m)
                    sent.append(payload)
                    recvd.append(recv)
            # the reversed schedule: the payload's cotangent goes back
            # through ppermute's transpose, one microbatch at a time
            leaves = tree_leaves(p)
            gsum = [torch.zeros_like(t) for t in leaves]
            for m in reversed(range(m_count)):
                if first:
                    outs = [recvd[m]]
                    seeds = [torch.zeros_like(recvd[m])]
                    inputs = leaves
                else:
                    outs = [losses[m]]
                    seeds = [torch.full_like(losses[m], 1.0 / m_count)]
                    inputs = leaves + [sent[m]]
                g = torch.autograd.grad(outs, inputs, grad_outputs=seeds,
                                        allow_unused=True)
                for i, gi in enumerate(g[:len(leaves)]):
                    if gi is not None:
                        gsum[i] += gi
            lacc = (torch.zeros((), device=x.device) if first else
                    torch.stack([v.detach() for v in losses]).sum()
                    / m_count)
            flat = all_reduce_flat(gsum + [lacc.reshape(1)], world,
                                   scale=1.0 / data.size, name="grads")
            new_top = dict(bn)
            new_top.update(_bn_tree_broadcast(bn, _ENC_KEYS, stage, 0))
            new_top.update(_bn_tree_broadcast(bn, _DEC_KEYS, stage, 1))
        return (flat[-1].reshape(()), {"top": new_top},
                tree_unflatten(params, flat[:-1]))

    return with_adam(loss_and_grads, policy)
