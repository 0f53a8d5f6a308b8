"""Onet weights and BatchNorm state made from the seed, on the device.

The tree has the port's keys and layout (HWIO conv weights, a
weight-shared twin under "top"), so the same tensors go to the program and
to the reference. Every leaf of one kind comes from one large draw on a
generator on the device: Kaiming-normal 3x3 weights (std sqrt(2 / 9ci)),
PyTorch's default transposed-conv init (uniform, bound 1/sqrt(4co)) and
bias, and a BatchNorm state that is not the identity (scale U(0.75, 1.25),
bias N(0, 0.1), running mean N(0, 0.1), running variance U(0.5, 1.5)), so
that folding does real work.
"""

from __future__ import annotations

import math

import torch

from benchmark.traffic.frames import _seed64


def _shapes(in_channels: int, base: int):
    ch = [base * m for m in (1, 2, 4, 8, 16)]
    dconv = [("inc", in_channels, ch[0])]
    dconv += [(f"down{i + 1}", ch[i], ch[i + 1]) for i in range(4)]
    ups = [(f"up{i + 1}", ch[4 - i], ch[3 - i]) for i in range(4)]
    return dconv, ups


def make(seed: int, in_channels: int, base: int, device):
    """(params, state): params {"top": unet}, state {"top": bn state}, all
    float32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed64(seed, 4))
    dconv, ups = _shapes(in_channels, base)
    convs = []                       # (path, ci, co) of every 3x3 conv
    bns = []                         # (path, c)
    for name, ci, co in dconv:
        convs += [((name, "conv1"), ci, co), ((name, "conv2"), co, co)]
        bns += [((name, "bn1"), co), ((name, "bn2"), co)]
    for name, ci, co in ups:
        convs += [((name, "conv", "conv1"), ci, co),
                  ((name, "conv", "conv2"), co, co)]
        bns += [((name, "conv", "bn1"), co), ((name, "conv", "bn2"), co)]
    n3 = sum(9 * ci * co for _, ci, co in convs)
    flat = torch.randn(n3, generator=gen, device=device)
    params, state = {}, {}

    def put(tree, path, val):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = val

    off = 0
    for path, ci, co in convs:
        k = 9 * ci * co
        w = flat[off:off + k].view(3, 3, ci, co) * math.sqrt(2.0 / (9 * ci))
        put(params, path + ("w",), w)
        off += k
    nt = sum(4 * ci * (ci // 2) + ci // 2 for _, ci, _ in ups)
    flat_t = torch.rand(nt, generator=gen, device=device) * 2 - 1
    off = 0
    for name, ci, _ in ups:
        co = ci // 2
        bound = 1.0 / math.sqrt(4 * co)
        put(params, (name, "up", "w"),
            flat_t[off:off + 4 * ci * co].view(2, 2, ci, co) * bound)
        off += 4 * ci * co
        put(params, (name, "up", "b"), flat_t[off:off + co] * bound)
        off += co
    nb = sum(c for _, c in bns)
    u = torch.rand((2, nb), generator=gen, device=device)
    g = torch.randn((2, nb), generator=gen, device=device)
    off = 0
    for path, c in bns:
        sl = slice(off, off + c)
        put(params, path + ("scale",), 0.75 + 0.5 * u[0, sl])
        put(params, path + ("bias",), 0.1 * g[0, sl])
        put(state, path + ("mean",), 0.1 * g[1, sl])
        put(state, path + ("var",), 0.5 + u[1, sl])
        off += c
    # leaves own their memory (not views of the draws)
    params = _tree_map(lambda t: t.contiguous().clone(), params)
    state = _tree_map(lambda t: t.contiguous().clone(), state)
    return {"top": params}, {"top": state}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix=()):
    """[(dotted path, tensor)] in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
        return out
    return [(".".join(prefix), tree)]
