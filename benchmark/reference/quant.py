"""Plain reference of the Onet's int8 serving path, worked out again from
the weights, the BatchNorm state and the calibration frames: folding,
calibration, quantization and the quantized forward, in float32 with
TF32 off. It imports nothing of the program.

The configuration it follows (``run.py serve --int8``, the port's
``models/quant.py``):

* fold: w' = w s, b' = beta - mean s, s = gamma / sqrt(var + eps);
* calibration: per-channel max |input| of each conv site on the folded
  forward of the calibration batch. The sites at the 64-channel levels
  run channel-stacked in the program, so each branch has its own scales
  there (inc.conv2, down1.conv1, up4.up, up4.conv1's two inputs,
  up4.conv2); the middle levels run both branches as one batch and share
  one scale;
* activation scale = max / qmax; weights: each site's activation scales
  folded into its input rows, then symmetric per-output-channel scales
  max |w| / qmax and codes round(w / sw) clamped to +-qmax;
* codes: post-ReLU activations clamp(round(y / s), 0, qmax), the
  transposed convs' outputs signed, clamp(round(y / s), -qmax, qmax); the
  input round(x / (1 / qmax)); max-pool on codes;
* a site computes acc * sw + b from its codes; inc.conv2 and up4.conv2,
  which make the head's features, run on the dequantized codes with the
  folded float weights (bf16 in the program, float32 here); up3.conv2
  keeps its float output, requantized after the branches are
  re-stacked.

``qmax`` 127 is the configuration's int8; 7 is int4, the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.onet import (DCONV_PATHS, EPS, _get, conv3, convT,
                                      exact_fp32, nchw, pad_to,
                                      twin_logits)

# sites whose scales are per branch (channel-stacked in the program)
STACKED = ("inc.conv2", "down1.conv1", "up4.up", "up4.conv1:skip",
           "up4.conv1:up", "up4.conv2")


def fold(params, state):
    """The folded tree: {path: {"conv1": {"w", "b"}, "conv2": ...}}."""
    top, st = params["top"], state["top"]
    out = {}
    for path in DCONV_PATHS:
        p, s = _get(top, path), _get(st, path)
        d = {}
        for c, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            sc = p[bn]["scale"] / torch.sqrt(s[bn]["var"] + EPS)
            d[c] = {"w": p[c]["w"] * sc, "b": p[bn]["bias"]
                    - s[bn]["mean"] * sc}
        out[".".join(path)] = d
    for i in range(1, 5):
        out[f"up{i}.up"] = top[f"up{i}"]["up"]
    return out


def _cbr(x, c):
    return torch.relu(conv3(x, c["w"], c["b"]))


def _maxc(t):
    return t.abs().amax(dim=(0, 2, 3))


def _float_taps(fp, x):
    """One branch's folded float forward; {site: per-channel max |input|}."""
    taps = {}
    h = _cbr(x, fp["inc"]["conv1"])
    taps["inc.conv2"] = _maxc(h)
    x1 = _cbr(h, fp["inc"]["conv2"])
    taps["up4.conv1:skip"] = _maxc(x1)
    hp = F.max_pool2d(x1, 2)
    taps["down1.conv1"] = _maxc(hp)
    h = _cbr(hp, fp["down1"]["conv1"])
    taps["down1.conv2"] = _maxc(h)
    feats = [x1, _cbr(h, fp["down1"]["conv2"])]
    for i in range(2, 5):
        hp = F.max_pool2d(feats[-1], 2)
        taps[f"down{i}.conv1"] = _maxc(hp)
        h = _cbr(hp, fp[f"down{i}"]["conv1"])
        taps[f"down{i}.conv2"] = _maxc(h)
        feats.append(_cbr(h, fp[f"down{i}"]["conv2"]))
    y = feats[-1]
    for i in range(1, 5):
        up = fp[f"up{i}.up"]
        taps[f"up{i}.up"] = _maxc(y)
        skip = feats[4 - i]
        u = pad_to(convT(y, up["w"], up["b"]), skip)
        if i < 4:
            taps[f"up{i}.conv1:skip"] = _maxc(skip)
        taps[f"up{i}.conv1:up"] = _maxc(u)
        h = _cbr(torch.cat([skip, u], 1), fp[f"up{i}.conv"]["conv1"])
        taps[f"up{i}.conv2"] = _maxc(h)
        y = _cbr(h, fp[f"up{i}.conv"]["conv2"])
    return taps


@torch.no_grad()
def calibrate(fp, x_nhwc, block: int = 8):
    """{site: [2, C] per-branch max |input|} over the calibration frames
    (row 0 the top branch, row 1 the down branch); shared sites hold the
    max over both branches in both rows."""
    acc = None
    with exact_fp32():
        for lo in range(0, x_nhwc.shape[0], block):
            x = nchw(x_nhwc[lo:lo + block].float())
            xd = torch.clamp(1.0 - x, 0.0, 1.0)
            tt, td = _float_taps(fp, x), _float_taps(fp, xd)
            cur = {k: torch.stack([tt[k], td[k]]) for k in tt}
            acc = cur if acc is None else {
                k: torch.maximum(acc[k], cur[k]) for k in acc}
    for k in acc:
        if k not in STACKED:
            acc[k] = acc[k].amax(0, keepdim=True).expand(2, -1).clone()
    return acc


def _qw(w_eff, qmax):
    sw = torch.clamp_min(w_eff.abs().amax(dim=(0, 1, 2)) / qmax, 1e-12)
    return torch.clamp(torch.round(w_eff / sw), -qmax, qmax), sw


def _codes(y, s, qmax, signed=False):
    lo = -qmax if signed else 0.0
    return torch.clamp(torch.round(y / s.view(1, -1, 1, 1)), lo, qmax)


def _site(codes, w, b, sx, qmax, transposed=False):
    """acc * sw + b of one int site: the activation scales ``sx`` [ci]
    folded into the weight's input rows, then quantized."""
    wq, sw = _qw(w * sx.view(1, 1, -1, 1), qmax)
    if transposed:
        acc = convT(codes, wq, torch.zeros_like(b))
    else:
        acc = conv3(codes, wq)
    return acc * sw.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def _branch_q(fp, s, x, br, qmax):
    """One branch's quantized forward to its features (loc, glob), with
    ``s`` the activation scales {site: [2, C]} and ``br`` 0 or 1."""
    sc = {k: v[br] for k, v in s.items()}
    xq = torch.clamp(torch.round(x / (1.0 / qmax)), 0.0, qmax)
    sx_in = torch.full((x.shape[1],), 1.0 / qmax, device=x.device)
    c = fp["inc"]["conv1"]
    h = _codes(_site(xq, c["w"], c["b"], sx_in, qmax), sc["inc.conv2"], qmax)
    c = fp["inc"]["conv2"]
    x1f = conv3(h * sc["inc.conv2"].view(1, -1, 1, 1), c["w"], c["b"])
    x1q = _codes(x1f, sc["up4.conv1:skip"], qmax)
    hp = F.max_pool2d(_codes(x1f, sc["down1.conv1"], qmax), 2)
    c = fp["down1"]["conv1"]
    h = _codes(_site(hp, c["w"], c["b"], sc["down1.conv1"], qmax),
               sc["down1.conv2"], qmax)
    skips = {}
    hq = h
    for i in range(1, 5):
        if i > 1:
            c = fp[f"down{i}"]["conv1"]
            hq = _codes(_site(F.max_pool2d(hq, 2), c["w"], c["b"],
                              sc[f"down{i}.conv1"], qmax),
                        sc[f"down{i}.conv2"], qmax)
        c = fp[f"down{i}"]["conv2"]
        y = _site(hq, c["w"], c["b"], sc[f"down{i}.conv2"], qmax)
        if i < 4:
            skips[i] = _codes(y, sc[f"up{4 - i}.conv1:skip"], qmax)
            hq = _codes(y, sc[f"down{i + 1}.conv1"], qmax)
        else:
            hq = _codes(y, sc["up1.up"], qmax)
    y = hq
    for i in range(1, 4):
        up = fp[f"up{i}.up"]
        u = _codes(_site(y, up["w"], up["b"], sc[f"up{i}.up"], qmax,
                         transposed=True), sc[f"up{i}.conv1:up"], qmax,
                   signed=True)
        skip = skips[4 - i]
        u = pad_to(u, skip)
        c = fp[f"up{i}.conv"]["conv1"]
        sx = torch.cat([sc[f"up{i}.conv1:skip"], sc[f"up{i}.conv1:up"]])
        h = _codes(_site(torch.cat([skip, u], 1), c["w"], c["b"], sx, qmax),
                   sc[f"up{i}.conv2"], qmax)
        c = fp[f"up{i}.conv"]["conv2"]
        yf = _site(h, c["w"], c["b"], sc[f"up{i}.conv2"], qmax)
        y = _codes(yf, sc[f"up{i + 1}.up"], qmax)
    up = fp["up4.up"]
    u = _codes(_site(y, up["w"], up["b"], sc["up4.up"], qmax,
                     transposed=True), sc["up4.conv1:up"], qmax, signed=True)
    u = pad_to(u, x1q)
    c = fp["up4.conv"]["conv1"]
    sx = torch.cat([sc["up4.conv1:skip"], sc["up4.conv1:up"]])
    h = _codes(_site(torch.cat([x1q, u], 1), c["w"], c["b"], sx, qmax),
               sc["up4.conv2"], qmax)
    c = fp["up4.conv"]["conv2"]
    y1f = conv3(h * sc["up4.conv2"].view(1, -1, 1, 1), c["w"], c["b"])
    return torch.relu(x1f), torch.relu(y1f)


@torch.no_grad()
def quant_logits(fp, scales, x_nhwc, *, qmax: float = 127.0,
                 block: int = 4):
    """(vt, vd) [N, H, W] of the quantized twin; ``scales`` the per-site
    max |input| from ``calibrate`` (divided by qmax here)."""
    s = {k: torch.clamp_min(v / qmax, 1e-12) for k, v in scales.items()}
    vts, vds = [], []
    with exact_fp32():
        for lo in range(0, x_nhwc.shape[0], block):
            x = nchw(x_nhwc[lo:lo + block].float())
            xd = torch.clamp(1.0 - x, 0.0, 1.0)
            lt, ht = _branch_q(fp, s, x, 0, qmax)
            ld, hd = _branch_q(fp, s, xd, 1, qmax)
            vt, vd = twin_logits(lt, ht, ld, hd)
            vts.append(vt)
            vds.append(vd)
    return torch.cat(vts), torch.cat(vds)
