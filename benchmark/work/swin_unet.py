"""Frozen work count of Swin-Unet in the Onet container: the operations
and bytes of its products, from the configuration's shapes alone.

The products of one branch on one image: the stem's 3x3 conv and the
4x4 patch-embed conv; in each Swin block the qkv, output, fc1 and fc2
linears and the two attention products (q k^T and the probabilities
times v, each window's T x T logits over T = w^2 tokens); the linears of
patch merging, patch expanding, the skip fusions, the final expanding and
the output projection. The weight-shared twin runs the branch on 2 x
frames images. A multiply-add is two operations. Bytes: each operand and
the output once, at the width the program computes them in.

Each item has its precision, as the program runs it under the
configuration's policy: the convs, the linears and the value product take
operands of the compute dtype; q k^T is a float32 product of float32
copies of the compute-dtype q and k, which the bf16 policy runs as TF32
(``core/policy.py``: TF32 holds bf16 values exactly), so it counts at the
TF32 peak there. Training counts, per product, the forward, the gradient
of its first operand ("dgrad") and of its second ("wgrad": the weight of
a linear or conv, k or v of an attention product), except the convs'
input gradients: their input is the data, which needs none. The list has
``work/onet.py::conv_work``'s form, so ``bound_seconds`` and
``ideal_seconds`` apply as they are.
"""

from __future__ import annotations

from benchmark.work.onet import BYTES

PATCH = 4


def branch_products(cfg):
    """The products of one branch on one image: dicts with ``site``,
    ``kind`` ("conv", "dense", "logits" or "values"), and ``m``, ``k``,
    ``n`` (a product of [m, k] by [k, n]), or for a conv ``m`` output
    pixels of ``k`` taps x input channels into ``n`` channels."""
    h, w = cfg["input_hw"]
    win = cfg["swin_window"]
    t = win * win
    d = [cfg["swin_embed"] * 2 ** i for i in range(4)]
    r, out, cin = cfg["mlp_ratio"], cfg["out_dim"], cfg["in_channels"]
    sides = [(h // PATCH // 2 ** i, w // PATCH // 2 ** i) for i in range(4)]
    pix = [a * b for a, b in sides]
    items = [dict(site="stem", kind="conv", m=h * w, k=9 * cin, n=out),
             dict(site="embed", kind="conv", m=pix[0], k=PATCH * PATCH * cin,
                  n=d[0])]

    def dense(site, m, k, n):
        items.append(dict(site=site, kind="dense", m=m, k=k, n=n))

    def blocks(name, i):
        c, m = d[i], pix[i]
        for b in range(cfg["depths"][i]):
            s = f"{name}.{b}"
            dense(s + ".qkv", m, c, 3 * c)
            # each window and head: [T, dh] x [dh, T], then [T, T] x [T, dh]
            items.append(dict(site=s + ".qk", kind="logits", m=m, k=c, n=t))
            items.append(dict(site=s + ".av", kind="values", m=m, k=t, n=c))
            dense(s + ".proj", m, c, c)
            dense(s + ".fc1", m, c, r * c)
            dense(s + ".fc2", m, r * c, c)

    for i in range(3):
        blocks(f"enc{i}", i)
        dense(f"merge{i}", pix[i + 1], 4 * d[i], 2 * d[i])
    blocks("bott", 3)
    for i in (2, 1, 0):
        dense(f"up{i}", pix[i + 1], 2 * d[i], 4 * d[i])
        dense(f"fuse{i}", pix[i], 2 * d[i], d[i])
        blocks(f"dec{i}", i)
    dense("final", pix[0], d[0], 16 * d[0])
    dense("out", h * w, d[0], out)
    return items


def _precision(cfg, kind):
    if kind == "logits":
        return "tf32" if cfg["precision"] == "bf16" else "fp32"
    return cfg["precision"]


def _elements(cfg, it, n):
    """(first operand, second operand, output) elements of a product on
    ``n`` images."""
    h, w = cfg["input_hw"]
    m, k, nn = it["m"], it["k"], it["n"]
    if it["kind"] == "conv":                # input, HWIO weight, output
        return n * h * w * cfg["in_channels"], k * nn, n * m * nn
    if it["kind"] == "logits":              # q, k, logits of every head
        return n * m * k, n * m * k, n * m * _heads(cfg, k) * nn
    if it["kind"] == "values":              # probabilities, v, output
        return n * m * _heads(cfg, nn) * k, n * m * nn, n * m * nn
    return n * m * k, k * nn, n * m * nn    # activations, weight, output


def _heads(cfg, c):
    """The heads of the stage of width ``c``."""
    return cfg["heads"][(c // cfg["swin_embed"]).bit_length() - 1]


def product_work(cfg, frames: int, *, train: bool):
    """Per call of the train step (``train``) or of a forward on
    ``frames`` frames: a list of dicts, one per product pass, with
    ``site``, ``kind``, ``pass_`` ("fwd", "dgrad", "wgrad"),
    ``precision``, ``ops`` and ``bytes``."""
    n = 2 * frames
    out = []
    for it in branch_products(cfg):
        p = _precision(cfg, it["kind"])
        row = dict(site=it["site"], kind=it["kind"], precision=p,
                   ops=2 * it["m"] * it["k"] * it["n"] * n,
                   bytes=sum(_elements(cfg, it, n)) * BYTES.get(p, 4))
        passes = ["fwd"]
        if train:
            passes += (["wgrad"] if it["kind"] == "conv"
                       else ["dgrad", "wgrad"])
        out += [dict(row, pass_=ps) for ps in passes]
    return out


def forward_ops_per_frame(cfg):
    """The twin forward's operations on one frame."""
    return sum(w["ops"] for w in product_work(cfg, 1, train=False))
