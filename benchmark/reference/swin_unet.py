"""Plain float32 reference of Swin-Unet in the Onet container: the
weight-shared twin, its JSD head and loss, and the train step with Adam.
PyTorch operations only, with TF32 off; it imports nothing of the program.

The backbone follows Swin-Unet (Cao et al., arXiv:2105.05537, Fig. 1 and
section 3) on the Swin Transformer's blocks (Liu et al.,
arXiv:2103.14030), at the geometry of the configuration:

* patch partition and linear embedding: a 4x4 stride-4 conv with bias,
  then LayerNorm;
* each Swin block: x + W-MSA(LN(x)), then x + MLP(LN(x)), the MLP
  linear (4x) -> GELU -> linear; every second block of a stage shifts its
  windows (SW-MSA) by half a window, cyclically, and masks the pairs that
  the shift brought together across a seam with -100; a stage whose
  feature map is one window takes no shift;
* window attention: qkv linear with bias, q scaled by dh^-1/2, q k^T plus
  the relative-position bias gathered from a (2w-1)^2 x heads table,
  softmax, the value product, an output linear;
* patch merging: the 2x2 neighbours concatenated in Swin's x0..x3 order
  ((0,0), (1,0), (0,1), (1,1)), LayerNorm(4D), linear 4D -> 2D without
  bias;
* the bottleneck: two Swin blocks at 1/32;
* patch expanding: linear D -> 2D without bias, the 2x2 rearrangement
  to twice the side at D/2 channels, LayerNorm(D/2);
* skip connections: at 1/4, 1/8 and 1/16 the encoder's features after
  that level's blocks (as Fig. 1 draws them), concatenated with the
  expanded decoder features and fused by a linear 2D -> D without bias;
* the final patch expanding: linear D -> 16D, the 4x4 rearrangement to
  full resolution at D channels, LayerNorm(D), then a linear projection.

Where it departs from the paper and from its official code
(github.com/HuCaoFighting/Swin-Unet,
``networks/swin_transformer_unet_skip_expand_decoder_sys.py``), each
point as the port has it:

* the Onet container around the backbone: the projection is to the 64
  global channels H, beside a full-resolution local stem L (3x3 conv
  without bias, LayerNorm, GELU) on the same input; the twin runs the one
  backbone on [X; 1 - X]; V_b = <L_b, H_b> over channels and the loss is
  the Onet's JSD (``reference/onet.py::twin_logits``, ``jsd_loss``);
* one input channel (radar amplitude) where the paper has three;
* the skips are each encoder level's features after its blocks, where
  ``forward_features`` keeps each level's input, before its blocks;
* the skip fusion (``concat_back_dim``) is a linear without bias, where
  the official one has a bias, and takes [skip, expanded] where the
  official code concatenates [expanded, skip] (a permutation of the
  fusion's rows under weights drawn from the seed);
* no LayerNorm after the bottleneck (``norm``) or before the final
  expanding (``norm_up``), which the official code has and the paper
  does not name;
* GELU is the tanh approximation (the port's, after ``jax.nn.gelu``),
  where ``nn.GELU`` is exact;
* no drop-path or dropout (the published recipe trains with stochastic
  depth);
* Adam at the Onet's learning rate, where Swin-Unet trains with SGD.

Weights come in the port's tree (``inputs/swin_weights.py``: the fuse
weight's first D rows take the skip, its last D the expanded features).
Training recomputes every block and every full-resolution part in the
backward pass, so that three float32 steps at batch 64 at 224^2 fit.
``cast`` rounds both operands of every linear and of the two convs
(``fp8_e4m3``: the control of a bf16 configuration; its gradient passes
straight through), and
``fault`` leaves out a part ("no_mask", "no_rpb") or takes the loss over
half of each batch ("half_batch"): the faults a check has to catch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.inputs.swin_weights import leaves, rebuild
from benchmark.reference.onet import (ADAM_EPS, B1, B2, exact_fp32,
                                      jsd_loss, twin_logits)

LN_EPS = 1e-5
PATCH = 4
FAULTS = ("no_mask", "no_rpb", "half_batch")


def straight_through(cast):
    """``cast``'s values forward, the identity backward."""
    if cast is None:
        return None
    return lambda t: t + (cast(t.detach()) - t).detach()


def layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], LN_EPS)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def linear(x, w, b=None, cast=None):
    if cast is not None:
        x, w = cast(x), cast(w)
    y = x @ w
    return y if b is None else y + b


def conv(x_nhwc, w_hwio, stride, padding, cast=None):
    if cast is not None:
        x_nhwc, w_hwio = cast(x_nhwc), cast(w_hwio)
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def partition(x, w):
    """[N, H, W, C] -> [N * windows, w * w, C], windows in row order."""
    n, h, wd, c = x.shape
    x = x.view(n, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def merge_windows(win, w, n, h, wd):
    c = win.shape[-1]
    x = win.view(n, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, wd, c)


def relative_index(w, device):
    """[w*w, w*w] index into the (2w-1)^2 table of token i's offset from
    token j."""
    g = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    c = torch.stack(g).flatten(1)                       # [2, T]
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).to(device)


def seam_mask(h, wd, w, s, device):
    """[windows, T, T]: 0 where two tokens of a shifted window came from
    one region of the unshifted map, -100 where from two."""
    region = torch.zeros(1, h, wd, 1)
    k = 0
    for rows in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for cols in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            region[:, rows, cols] = k
            k += 1
    ids = partition(region, w)[..., 0]                  # [windows, T]
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(device)


def window_attention(p, x, heads, w, shift, cast, fault):
    n, h, wd, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = partition(x, w)
    bw, t, _ = xw.shape
    dh = c // heads
    qkv = linear(xw, p["qkv"]["w"], p["qkv"]["b"], cast)
    q, k, v = qkv.view(bw, t, 3, heads, dh).permute(2, 0, 3, 1, 4)
    attn = (q * dh ** -0.5) @ k.transpose(-2, -1)       # [bw, heads, T, T]
    if "no_rpb" not in fault:
        idx = relative_index(w, x.device).reshape(-1)
        attn = attn + p["rpb"][idx].view(t, t, heads).permute(2, 0, 1)
    if shift and "no_mask" not in fault:
        m = seam_mask(h, wd, w, shift, x.device)
        attn = (attn.view(bw // m.shape[0], m.shape[0], heads, t, t)
                + m[None, :, None]).view(bw, heads, t, t)
    out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, t, c)
    out = linear(out, p["proj"]["w"], p["proj"]["b"], cast)
    x = merge_windows(out, w, n, h, wd)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x


def swin_block(p, x, heads, w, shift, cast, fault):
    x = x + window_attention(p["attn"], layer_norm(x, p["ln1"]), heads, w,
                             shift, cast, fault)
    hid = gelu(linear(layer_norm(x, p["ln2"]), p["fc1"]["w"], p["fc1"]["b"],
                      cast))
    return x + linear(hid, p["fc2"]["w"], p["fc2"]["b"], cast)


def rearrange_up(x, r):
    """[N, H, W, r*r*C] -> [N, rH, rW, C]: channel block (a, b) to the
    pixel (r*i + a, r*j + b)."""
    n, h, wd, rrc = x.shape
    c = rrc // (r * r)
    x = x.view(n, h, wd, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, r * h, r * wd, c)


def branch(p, x, *, window, train, cast=None, fault=()):
    """One Swin-Unet with the Onet's stem on x [N, H, W, Cin]: (L, H),
    both [N, H, W, 64]."""
    def ck(fn, *args):
        if train:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    heads = [p[s][0]["attn"]["rpb"].shape[1]
             for s in ("enc0", "enc1", "enc2", "bott")]

    def stage(blocks, e, hd):
        shift = window // 2 if e.shape[1] > window else 0
        for i, bp in enumerate(blocks):
            e = ck(lambda z, _p=bp, _s=shift if i % 2 else 0:
                   swin_block(_p, z, hd, window, _s, cast, fault), e)
        return e

    loc = ck(lambda z: gelu(layer_norm(conv(z, p["stem"]["w"], 1, 1, cast),
                                       p["stem"]["ln"])), x)
    e = ck(lambda z: layer_norm(conv(z, p["embed"]["w"], PATCH, 0, cast)
                                + p["embed"]["b"], p["embed"]["ln"]), x)
    skips = []
    for i in range(3):
        e = stage(p[f"enc{i}"], e, heads[i])
        skips.append(e)
        m = p[f"merge{i}"]
        e = ck(lambda z, _m=m: linear(layer_norm(torch.cat(
            [z[:, 0::2, 0::2], z[:, 1::2, 0::2], z[:, 0::2, 1::2],
             z[:, 1::2, 1::2]], dim=-1), _m["ln"]), _m["w_only"], None,
            cast), e)
    e = stage(p["bott"], e, heads[3])
    for i in (2, 1, 0):
        up, fw = p[f"up{i}"], p[f"fuse{i}"]["w"]
        d = fw.shape[1]

        def decode_in(z, skip, _up=up, _fw=fw, _d=d):
            z = layer_norm(rearrange_up(linear(z, _up["w_only"], None, cast),
                                        2), _up["ln"])
            return (linear(skip, _fw[:_d], None, cast)
                    + linear(z, _fw[_d:], None, cast))

        e = ck(decode_in, e, skips[i])
        e = stage(p[f"dec{i}"], e, heads[i])
    fin, out = p["final"], p["out"]
    glob = ck(lambda z: linear(layer_norm(rearrange_up(
        linear(z, fin["w_only"], None, cast), 4), fin["ln"]),
        out["w"], out["b"], cast), e)
    return loc, glob


def twin(p, x, *, window, bias=0.0, train=False, cast=None, fault=()):
    """(Lt, Ld, Vt, Vd) of the weight-shared twin on x [B, H, W, Cin]:
    the one backbone on [X; clip(1 - X + bias, 0, 1)]."""
    b = x.shape[0]
    xd = torch.clamp(1.0 - x + bias, 0.0, 1.0)
    loc, glob = branch(p, torch.cat([x, xd]), window=window, train=train,
                       cast=cast, fault=fault)
    loc, glob = loc.movedim(-1, 1), glob.movedim(-1, 1)     # NCHW views
    vt, vd = twin_logits(loc[:b], glob[:b], loc[b:], glob[b:])
    return loc[:b], loc[b:], vt, vd


def loss_of(p, x, *, window, bias=0.0, train=False, cast=None, fault=()):
    lt, ld, vt, vd = twin(p, x, window=window, bias=bias, train=train,
                          cast=cast, fault=fault)
    if "half_batch" in fault:
        n = x.shape[0] // 2
        lt, ld, vt, vd = lt[:n], ld[:n], vt[:n], vd[:n]
    return jsd_loss(lt, ld, vt, vd)


def geometry(cfg) -> dict:
    """The configuration's keywords of ``train_steps`` beyond the weights'
    shapes: the window."""
    return {"window": cfg["swin_window"]}


def train_steps(params, batches, lr: float, *, window: int, bias=0.0,
                adam=None, cast=None, fault=()):
    """Run the reference train step on each NHWC batch in order, from
    ``params`` (the port's tree, float32; copied, not changed). Returns
    {"loss": [per step], "grad": {leaf: norm of step 1's gradient},
    "param": {leaf: params after the last step}}."""
    b1, b2, eps = ((adam["b1"], adam["b2"], adam["eps"]) if adam
                   else (B1, B2, ADAM_EPS))
    unknown = set(fault) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    cast = straight_through(cast)
    with exact_fp32():
        p = {k: v.detach().float().clone().requires_grad_(True)
             for k, v in leaves(params)}
        tree = rebuild(params, p)["top"]
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        out = {"loss": [], "grad": None}
        names = list(p)
        for t, xb in enumerate(batches, start=1):
            loss = loss_of(tree, xb.float(), window=window, bias=bias,
                           train=True, cast=cast, fault=fault)
            grads = torch.autograd.grad(loss, [p[k] for k in names],
                                        allow_unused=True)
            grads = [torch.zeros_like(p[k]) if gr is None else gr
                     for k, gr in zip(names, grads)]
            out["loss"].append(float(loss.detach()))
            if out["grad"] is None:
                out["grad"] = {k: float(g.norm())
                               for k, g in zip(names, grads)}
            with torch.no_grad():
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v2[k].mul_(b2).add_((1 - b2) * g * g)
                    mh = m[k] / (1 - b1 ** t)
                    vh = v2[k] / (1 - b2 ** t)
                    p[k].sub_(lr * mh / (torch.sqrt(vh) + eps))
            del grads, loss
        out["param"] = {k: v.detach() for k, v in p.items()}
        return out
