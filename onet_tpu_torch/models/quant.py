"""Int8 post-training-quantized serving path (``onet_tpu/models/quant.py``).

The BN-folded inference graph (``models/infer.py``) with:

* symmetric per-output-channel weight scales,
* per-site static activation scales from a calibration pass,
* concat inputs handled exactly by folding each segment's activation scale
  into the corresponding weight rows before weight quantization (a conv of
  a mixed-scale concat is then a plain int8 conv),
* ReLU folded into the requantization clamp (post-ReLU activations live in
  [0, 127]),
* max-pool on the int8 tensor directly (max commutes with the monotone
  quantization map).

An opt-in serving mode. Accuracy contract: >= 99% mask agreement with the
bf16 folded graph (``tests/test_torch_quant.py``; ``chip_smoke.py`` phase
10 at full width on a trained checkpoint).

The int8 convs run on ``ops/conv_i8.py`` (hand-written kernels on the
card, their plain versions on the CPU), the requantization fused into the
epilogue: of a conv with one consumer, and of down1-3.conv2, whose output
feeds a skip and the next conv, to both consumers' codes in one launch. The parameters ``q`` keep the JAX
package's keys and leaves: per site ``wq`` (int8 HWIO), ``sw`` and ``b``
(f32), the ``scales`` dict and the float ``in_scale``. Scale arithmetic
divides by tensors, never by a Python scalar: PyTorch's CUDA kernels turn
a scalar divisor into a multiply by its reciprocal, which rounds apart
from a division.

Reference workload shape: Onet_vanilla_20240606.py:104-153.
"""

from __future__ import annotations

import torch

from onet_tpu_torch.core.policy import BF16_COMPUTE
from onet_tpu_torch.models import infer as I
from onet_tpu_torch.models.layers import (
    bd2, bd2_skip_up, conv3x3, conv_transpose_2x2, interleave_branches,
    max_pool_2x2, restack_branches)
from onet_tpu_torch.models.onet import stacked_head
from onet_tpu_torch.models.unet import pad_to
from onet_tpu_torch.ops.conv_i8 import QMAX, conv3x3_i8, convT2x2_i8
from onet_tpu_torch.ops.math import div
from onet_tpu_torch.ops.normalize import complement

# conv sites of the stacked folded graph, in execution order. Sites whose
# input is a concat carry one scale per segment.
SITES = (
    "inc.conv1", "inc.conv2", "down1.conv1", "down1.conv2",
    "down2.conv1", "down2.conv2", "down3.conv1", "down3.conv2",
    "down4.conv1", "down4.conv2",
    "up1.up", "up1.conv1", "up1.conv2",
    "up2.up", "up2.conv1", "up2.conv2",
    "up3.up", "up3.conv1", "up3.conv2",
    "up4.up", "up4.conv1", "up4.conv2",
)


# ---------------------------------------------------------------------------
# calibration: record per-site input max on the bf16 folded graph
# ---------------------------------------------------------------------------

def _site_max(x):
    """Per-channel abs-max over (B, H, W): [C] float32."""
    return torch.amax(torch.abs(x.float()), dim=(0, 1, 2))


def calibrate(folded, x, *, bias: float = 0.0, policy=None):
    """Run the bf16 stacked folded graph on a calibration batch and return
    {site: per-channel max |input|} (f32 tensors on x's device). ``x`` is
    [B, H, W, cin] in [0, 1]."""
    policy = policy or BF16_COMPUTE
    taps = {}

    def record(name, t):
        taps[name] = _site_max(t)
        return t

    with torch.no_grad(), policy.precision():
        _stacked_folded_with_taps(folded["top"], x, bias, policy, record)
    return taps


def _stacked_folded_with_taps(fp, x, bias, policy, tap):
    """Mirror of infer.unet_infer_stacked with a tap before every conv.
    Concat sites tap each segment separately ('<site>:skip'/'<site>:up').
    Calibration stats are max-abs per channel, invariant to the batch
    permutation dp_local applies: one calibration serves both layouts."""
    xd = complement(x, bias)
    xx = torch.cat([x, xd], dim=-1)
    b = xx.shape[0]
    h = I._cbr_stacked(tap("inc.conv1", xx), fp["inc"]["conv1"], policy)
    x1s = I._cbr_stacked(tap("inc.conv2", h), fp["inc"]["conv2"], policy)
    hp = max_pool_2x2(x1s)
    h = I._cbr_stacked(tap("down1.conv1", hp), fp["down1"]["conv1"], policy)
    c1 = h.shape[-1] // 2
    xb = torch.cat([h[..., :c1], h[..., c1:]], dim=0)
    feats = [None]
    hcur = I._conv_bias_relu(tap("down1.conv2", xb), fp["down1"]["conv2"],
                             policy)
    feats.append(hcur)
    for i in range(2, 5):
        hp = max_pool_2x2(hcur)
        hcur = I._conv_bias_relu(tap(f"down{i}.conv1", hp),
                                 fp[f"down{i}"]["conv1"], policy)
        hcur = I._conv_bias_relu(tap(f"down{i}.conv2", hcur),
                                 fp[f"down{i}"]["conv2"], policy)
        feats.append(hcur)
    y = feats[-1]
    for i in range(1, 4):
        up = fp[f"up{i}"]["up"]
        y = conv_transpose_2x2(tap(f"up{i}.up", y), up["w"], up["b"],
                               policy=policy)
        skip = feats[4 - i]
        y = pad_to(y, skip)
        tap(f"up{i}.conv1:skip", skip)
        y = torch.cat([skip, tap(f"up{i}.conv1:up", y)], dim=-1)
        y = I._conv_bias_relu(y, fp[f"up{i}"]["conv"]["conv1"], policy)
        y = I._conv_bias_relu(tap(f"up{i}.conv2", y),
                              fp[f"up{i}"]["conv"]["conv2"], policy)
    y2s = torch.cat([y[:b], y[b:]], dim=-1)
    up = fp["up4"]["up"]
    u = conv_transpose_2x2(tap("up4.up", y2s), bd2(up["w"]),
                           up["b"].repeat(2), policy=policy)
    u = pad_to(u, x1s)
    tap("up4.conv1:skip", x1s)
    xin = torch.cat([x1s, tap("up4.conv1:up", u)], dim=-1)
    c = x1s.shape[-1] // 2
    pc = fp["up4"]["conv"]
    hh = I._cbr_stacked(xin, pc["conv1"], policy,
                        wmap=lambda w: bd2_skip_up(w, c_skip=c))
    y1s = I._cbr_stacked(tap("up4.conv2", hh), pc["conv2"], policy)
    return x1s, y1s


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------

def _quant_w(w_eff):
    """Symmetric per-output-channel int8 quantization of [kh,kw,ci,co]."""
    sw = div(torch.amax(torch.abs(w_eff), dim=(0, 1, 2)), QMAX)
    sw = torch.clamp_min(sw, 1e-12)
    wq = torch.clamp(torch.round(w_eff / sw), -QMAX, QMAX).to(torch.int8)
    return wq, sw.float()


def _qsite(w, b, sx_vec):
    """Quantize one conv site. ``sx_vec`` is the per-input-channel
    activation scale vector [ci] (constant per segment); it folds into the
    weight so the int8 conv consumes raw int8 codes."""
    w_eff = w.float() * sx_vec[None, None, :, None]
    wq, sw = _quant_w(w_eff)
    return {"wq": wq, "sw": sw, "b": b.float()}


def quantize_folded(folded, scales, *, in_scale: float = 1.0 / QMAX):
    """Build the int8 serving params from BN-folded params + calibration
    scales (the dict from ``calibrate``). Weight-shared stacked graph only.

    Activation code contract: every tensor entering a conv is int8 in
    [0, 127] with real value = code * s_site (post-ReLU sites), except the
    input which uses ``in_scale`` on [0, 1] values, and the transposed
    convs' outputs, signed in [-127, 127].
    """
    fp = folded["top"]
    dev = fp["inc"]["conv1"]["w"].device
    s = {k: torch.clamp_min(div(torch.as_tensor(v, dtype=torch.float32,
                                                 device=dev), QMAX), 1e-12)
         for k, v in scales.items()}

    def vec(site, ci):
        v = s[site]
        assert v.shape == (ci,), (site, v.shape, ci)
        return v

    q = {"in_scale": in_scale, "scales": s}
    cin2 = fp["inc"]["conv1"]["w"].shape[2] * 2
    q["inc.conv1"] = _qsite(bd2(fp["inc"]["conv1"]["w"]),
                            fp["inc"]["conv1"]["b"].repeat(2),
                            torch.full((cin2,), in_scale, dtype=torch.float32,
                                       device=dev))
    q["inc.conv2"] = _qsite(bd2(fp["inc"]["conv2"]["w"]),
                            fp["inc"]["conv2"]["b"].repeat(2),
                            vec("inc.conv2",
                                fp["inc"]["conv2"]["w"].shape[2] * 2))
    q["down1.conv1"] = _qsite(bd2(fp["down1"]["conv1"]["w"]),
                              fp["down1"]["conv1"]["b"].repeat(2),
                              vec("down1.conv1",
                                  fp["down1"]["conv1"]["w"].shape[2] * 2))
    q["down1.conv2"] = _qsite(fp["down1"]["conv2"]["w"],
                              fp["down1"]["conv2"]["b"],
                              vec("down1.conv2",
                                  fp["down1"]["conv2"]["w"].shape[2]))
    for i in range(2, 5):
        for cname in ("conv1", "conv2"):
            site = f"down{i}.{cname}"
            w = fp[f"down{i}"][cname]["w"]
            q[site] = _qsite(w, fp[f"down{i}"][cname]["b"],
                             vec(site, w.shape[2]))
    for i in range(1, 4):
        up = fp[f"up{i}"]["up"]
        site = f"up{i}.up"
        q[site] = _qsite(up["w"].flip(0, 1), up["b"],
                         vec(site, up["w"].shape[2]))
        wc1 = fp[f"up{i}"]["conv"]["conv1"]["w"]
        sx_vec = torch.cat([s[f"up{i}.conv1:skip"], s[f"up{i}.conv1:up"]])
        assert sx_vec.shape == (wc1.shape[2],)
        q[f"up{i}.conv1"] = _qsite(wc1, fp[f"up{i}"]["conv"]["conv1"]["b"],
                                   sx_vec)
        wc2 = fp[f"up{i}"]["conv"]["conv2"]["w"]
        q[f"up{i}.conv2"] = _qsite(wc2, fp[f"up{i}"]["conv"]["conv2"]["b"],
                                   vec(f"up{i}.conv2", wc2.shape[2]))
    up = fp["up4"]["up"]
    q["up4.up"] = _qsite(bd2(up["w"].flip(0, 1)), up["b"].repeat(2),
                         vec("up4.up", up["w"].shape[2] * 2))
    pc = fp["up4"]["conv"]
    c_skip = pc["conv1"]["w"].shape[2] - pc["conv1"]["w"].shape[3]
    wstk = bd2_skip_up(pc["conv1"]["w"], c_skip=c_skip)
    sx_vec = torch.cat([s["up4.conv1:skip"], s["up4.conv1:up"]])
    assert sx_vec.shape == (wstk.shape[2],)
    q["up4.conv1"] = _qsite(wstk, pc["conv1"]["b"].repeat(2), sx_vec)
    q["up4.conv2"] = _qsite(bd2(pc["conv2"]["w"]), pc["conv2"]["b"].repeat(2),
                            vec("up4.conv2", pc["conv2"]["w"].shape[2] * 2))
    # bf16 head-feature sites (see onet_infer_q's docstring)
    q["inc.conv2.bf16"] = {"w": bd2(fp["inc"]["conv2"]["w"]),
                           "b": fp["inc"]["conv2"]["b"].repeat(2).float()}
    q["up4.conv2.bf16"] = {"w": bd2(pc["conv2"]["w"]),
                           "b": pc["conv2"]["b"].repeat(2).float()}
    return q


# ---------------------------------------------------------------------------
# int8 execution
# ---------------------------------------------------------------------------

def _conv_bf16(x16, site):
    """bf16 conv rounded to bf16 (as XLA's bf16 conv), then + b in f32."""
    y = conv3x3(x16, site["w"], policy=BF16_COMPUTE)
    return y.float() + site["b"]


def _conv_i8(xq, site, **requant):
    """int8 conv -> acc * sw + b in f32, or with ``requant=`` and
    ``s_next=`` its codes (the requantization fused into the kernel)."""
    return conv3x3_i8(xq, site["wq"], site["sw"], site["b"], **requant)


def _requant(y, s_next):
    """ReLU + quantize to the next site's input codes (clamp handles both:
    post-ReLU codes live in [0, 127])."""
    return torch.clamp(torch.round(y / s_next), 0.0, QMAX).to(torch.int8)


def _requant_signed(y, s_next):
    """Symmetric signed quantization for tensors that are not post-ReLU:
    the four conv-transpose outputs feed the decoder concats unrectified
    (clamping them at 0 cost the JAX package 92% mask agreement)."""
    return torch.clamp(torch.round(y / s_next), -QMAX, QMAX).to(torch.int8)


def _cbr_q(xq, site, s_next):
    """conv + bias, ReLU and requantization: ``_requant(_conv_i8(...))``
    in one kernel."""
    return _conv_i8(xq, site, requant="unsigned", s_next=s_next)


def _cbr_q2(xq, site, s_a, s_b):
    """conv + bias, ReLU and the requantization to two consumers' codes
    (``_requant`` of one ``_conv_i8`` at ``s_a`` and at ``s_b``) in one
    kernel: no f32 tensor is written."""
    return _conv_i8(xq, site, requant=("unsigned", "unsigned"),
                    s_next=(s_a, s_b))


def _pool_q(xq):
    """2x2 max-pool of int8 codes with floor semantics (odd sizes crop)."""
    n, h, w, c = xq.shape
    if h % 2 or w % 2:
        xq = xq[:, : h // 2 * 2, : w // 2 * 2, :]
    xr = xq.reshape(n, h // 2, 2, w // 2, 2, c)
    return torch.amax(torch.amax(xr, dim=4), dim=2)


def _pad_match(y, skip):
    """Zero-pad a decoder tensor to the skip's spatial size (the
    reference's asymmetric F.pad). Zero codes decode to 0.0 under both
    unsigned and signed requantization, so the pad is exact in int8."""
    return pad_to(y, skip)


def _convT_q(xq, site, s_next):
    """Kernel-2 stride-2 transposed conv in int8 with the signed
    requantization fused (quantize_folded stores the pre-reversed
    kernel)."""
    return convT2x2_i8(xq, site["wq"], site["sw"], site["b"],
                       requant="signed", s_next=s_next)


def onet_infer_q(q, x, *, bias: float = 0.0, head_bf16: bool = True,
                 dp_local: bool = False):
    """Int8 serving forward: [B, H, W, cin] in [0, 1] ->
    (S [B, H, W, 2] f32, labels [B, H, W]). Weight-shared stacked graph.

    ``head_bf16`` keeps the two convs producing the head features
    (inc.conv2 -> L, up4.conv2 -> H) in bf16: the projection <L, H>
    contracts 64 products per pixel, so head-feature noise multiplies.
    ``head_bf16=False`` runs all 22 sites int8. One int8 kernel launch a
    site: 16 3x3 (18 without the bf16 head) and 4 transposed.
    """
    s = q["scales"]
    xd = complement(x, bias)
    xx = torch.cat([x, xd], dim=-1)
    b = x.shape[0]
    xq = torch.clamp(torch.round(div(xx, q["in_scale"])), 0.0,
                     QMAX).to(torch.int8)
    h = _cbr_q(xq, q["inc.conv1"], s["inc.conv2"])
    if head_bf16:
        hf16 = (h.float() * s["inc.conv2"]).to(torch.bfloat16)
        x1f = _conv_bf16(hf16, q["inc.conv2.bf16"])
    else:
        x1f = _conv_i8(h, q["inc.conv2"])
    x1q = _requant(x1f, s["up4.conv1:skip"])    # skip codes for up4
    hp = _pool_q(_requant(x1f, s["down1.conv1"]))
    # down1.conv1's output is channel-stacked; its consumer down1.conv2 is
    # calibrated on the batch-unstacked tensor, so tile its [C] scale
    h = _cbr_q(hp, q["down1.conv1"], s["down1.conv2"].repeat(2))
    if dp_local:
        xb = interleave_branches(h)
    else:
        c1 = h.shape[-1] // 2
        xb = torch.cat([h[..., :c1], h[..., c1:]], dim=0)
    feats = [None]
    skip_scale = {1: s["up3.conv1:skip"], 2: s["up2.conv1:skip"],
                  3: s["up1.conv1:skip"]}
    # int8 skip codes and the next conv's, from one launch
    skq, hq = _cbr_q2(xb, q["down1.conv2"], skip_scale[1], s["down2.conv1"])
    feats.append(skq)
    for i in range(2, 5):
        hq = _pool_q(hq)
        hq = _cbr_q(hq, q[f"down{i}.conv1"], s[f"down{i}.conv2"])
        if i < 4:
            skq, hq = _cbr_q2(hq, q[f"down{i}.conv2"], skip_scale[i],
                              s[f"down{i+1}.conv1"])
            feats.append(skq)
        else:                                   # the bottleneck: no skip
            hq = _cbr_q(hq, q["down4.conv2"], s["up1.up"])
    y = hq
    for i in range(1, 4):
        yq = _convT_q(y, q[f"up{i}.up"], s[f"up{i}.conv1:up"])
        skq = feats[4 - i]
        yq = _pad_match(yq, skq)
        xin = torch.cat([skq, yq], dim=-1)
        y = _cbr_q(xin, q[f"up{i}.conv1"], s[f"up{i}.conv2"])
        if i < 3:
            y = _cbr_q(y, q[f"up{i}.conv2"], s[f"up{i+1}.up"])
        else:
            # restack to channel form before requanting: up4.up's
            # per-channel scales are calibrated on the channel-stacked
            # tensor and the two branch blocks requantize differently
            yf = _conv_i8(y, q["up3.conv2"])
            y2f = (restack_branches(yf) if dp_local else
                   torch.cat([yf[:b], yf[b:]], dim=-1))
            y = _requant(y2f, s["up4.up"])
    uq = _convT_q(y, q["up4.up"], s["up4.conv1:up"])
    uq = _pad_match(uq, x1q)
    xin = torch.cat([x1q, uq], dim=-1)
    h = _cbr_q(xin, q["up4.conv1"], s["up4.conv2"])
    if head_bf16:
        hf16 = (h.float() * s["up4.conv2"]).to(torch.bfloat16)
        y1f = _conv_bf16(hf16, q["up4.conv2.bf16"])
    else:
        y1f = _conv_i8(h, q["up4.conv2"])
    # head on the ReLU'd features in bf16, as the bf16 serving path's
    loc = torch.clamp_min(x1f, 0.0).to(torch.bfloat16)
    glob = torch.clamp_min(y1f, 0.0).to(torch.bfloat16)
    v, _ = stacked_head(loc, glob)
    sfm = torch.softmax(v, dim=-1)
    return sfm, torch.argmax(sfm, dim=-1)
