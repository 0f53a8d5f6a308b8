"""Swin-Unet weights made from the seed, on the device.

The tree has the port's keys and layout (``{"top": branch}``, a
weight-shared twin; linear weights [in, out], conv weights HWIO, each
stage a list of blocks), so the same tensors go to the program and to the
reference. The geometry is the configuration's: ``in_channels``,
``swin_embed``, ``swin_window``, ``depths``, ``heads``, ``mlp_ratio``,
``out_dim``. Every leaf of one law comes from one draw on a generator on
the device:

* linear and patch-embed weights and the relative-position bias tables:
  a normal truncated at two standard deviations, std 0.02 (Swin's init);
* the stem's 3x3 conv: Kaiming-normal, std sqrt(2 / 9ci);
* biases: N(0, 0.02), and LayerNorm gains U(0.75, 1.25) and offsets
  N(0, 0.05), so that neither is the identity and both do work.
"""

from __future__ import annotations

import math

import torch

from benchmark.traffic.frames import _seed64

PATCH = 4


def _specs(cfg):
    """[(path, shape, law)] of one branch in a fixed order."""
    d = [cfg["swin_embed"] * 2 ** i for i in range(4)]
    w, r = cfg["swin_window"], cfg["mlp_ratio"]
    cin, out = cfg["in_channels"], cfg["out_dim"]
    specs = []

    def linear(path, din, dout, bias=True, key="w"):
        specs.append((path + (key,), (din, dout), "trunc"))
        if bias:
            specs.append((path + ("b",), (dout,), "bias"))

    def ln(path, c):
        specs.append((path + ("g",), (c,), "gain"))
        specs.append((path + ("b",), (c,), "offset"))

    def blocks(name, i):
        for k in range(cfg["depths"][i]):
            p = (name, k)
            ln(p + ("ln1",), d[i])
            linear(p + ("attn", "qkv"), d[i], 3 * d[i])
            linear(p + ("attn", "proj"), d[i], d[i])
            specs.append((p + ("attn", "rpb"),
                          ((2 * w - 1) ** 2, cfg["heads"][i]), "trunc"))
            ln(p + ("ln2",), d[i])
            linear(p + ("fc1",), d[i], r * d[i])
            linear(p + ("fc2",), r * d[i], d[i])

    specs.append((("stem", "w"), (3, 3, cin, out), "kaiming"))
    ln(("stem", "ln"), out)
    specs.append((("embed", "w"), (PATCH, PATCH, cin, d[0]), "trunc"))
    specs.append((("embed", "b"), (d[0],), "bias"))
    ln(("embed", "ln"), d[0])
    for i in range(3):
        blocks(f"enc{i}", i)
        ln((f"merge{i}", "ln"), 4 * d[i])
        linear((f"merge{i}",), 4 * d[i], 2 * d[i], bias=False, key="w_only")
    blocks("bott", 3)
    for i in (2, 1, 0):
        linear((f"up{i}",), 2 * d[i], 4 * d[i], bias=False, key="w_only")
        ln((f"up{i}", "ln"), d[i])
        linear((f"fuse{i}",), 2 * d[i], d[i], bias=False)
        blocks(f"dec{i}", i)
    linear(("final",), d[0], 16 * d[0], bias=False, key="w_only")
    ln(("final", "ln"), d[0])
    linear(("out",), d[0], out)
    return specs


def _draw(law, n, gen, device):
    if law == "trunc":
        lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        return (0.02 * z.clamp(-2.0, 2.0)).float()
    if law == "gain":
        return 0.75 + 0.5 * torch.rand(n, generator=gen, device=device)
    std = {"kaiming": 1.0, "bias": 0.02, "offset": 0.05}[law]
    return std * torch.randn(n, generator=gen, device=device)


def make(seed: int, cfg, device):
    """(params, state): params {"top": branch} float32 on ``device``,
    state {"top": {}} (LayerNorm keeps no statistics)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed64(seed, 5))
    specs = _specs(cfg)
    flat = {}
    for law in ("trunc", "kaiming", "bias", "gain", "offset"):
        mine = [(p, s) for p, s, lw in specs if lw == law]
        draw = _draw(law, sum(math.prod(s) for _, s in mine), gen, device)
        off = 0
        for path, shape in mine:
            k = math.prod(shape)
            t = draw[off:off + k].view(shape).clone()
            if law == "kaiming":
                t *= math.sqrt(2.0 / (9 * shape[2]))
            flat[path] = t
            off += k
    tree = {}
    for path, _, _ in specs:
        node = tree
        for a, b in zip(path[:-1], path[1:]):
            if isinstance(b, int):
                node = node.setdefault(a, [])
            elif isinstance(a, int):
                while len(node) <= a:
                    node.append({})
                node = node[a]
            else:
                node = node.setdefault(a, {})
        node[path[-1]] = flat[path]
    return {"top": tree}, {"top": {}}


def leaves(tree, prefix=()):
    """[(dotted path, tensor)] in sorted key order, list items by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k],
                                                          prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree)
                for kv in leaves(t, prefix + (str(i),))]
    return [(".".join(prefix), tree)]


def rebuild(tree, flat, prefix=()):
    """A tree shaped like ``tree`` whose leaves are ``flat[dotted path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rebuild(v, flat, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return flat[".".join(prefix)]

