"""Frozen work count of the Onet U-Net: the operations and bytes of its
true convolutions, from the configuration's shapes alone.

One branch of the twin is a U-Net of widths base x (1, 2, 4, 8, 16):
DoubleConv = two 3x3 SAME convs, Down = 2x2 max-pool + DoubleConv, Up =
2x2 stride-2 transposed conv + concat(skip, up) + DoubleConv. A twin
forward runs the branch twice (on X and on its complement). What is
counted is the model's own convolutions, whatever kernel runs them: the
block-diagonal doubling of a channel-stacked implementation is not work.
A multiply-add is two operations. Bytes: each input, weight and output
element once, at the width the configuration states for that site.

Training counts, per conv, the forward, the weight gradient and the input
gradient, except the input gradient of the first conv (its input is the
data, which needs none).
"""

from __future__ import annotations

SITE_NAMES = (
    "inc.conv1", "inc.conv2", "down1.conv1", "down1.conv2",
    "down2.conv1", "down2.conv2", "down3.conv1", "down3.conv2",
    "down4.conv1", "down4.conv2",
    "up1.up", "up1.conv1", "up1.conv2",
    "up2.up", "up2.conv1", "up2.conv2",
    "up3.up", "up3.conv1", "up3.conv2",
    "up4.up", "up4.conv1", "up4.conv2",
)

BYTES = {"fp32": 4, "f32": 4, "bf16": 2, "int8": 1, "i8": 1}


def branch_sites(in_channels: int, base: int, height: int, width: int):
    """The convs of one U-Net branch: a list of dicts with ``site``,
    ``kind`` ("3x3" or "convT"), ``ci``, ``co`` and the output's
    ``h``/``w``. Odd sizes floor at each pool, as the model does."""
    ch = [base * m for m in (1, 2, 4, 8, 16)]
    hs, ws = [height], [width]
    for _ in range(4):
        hs.append(hs[-1] // 2)
        ws.append(ws[-1] // 2)
    out = [dict(site="inc.conv1", kind="3x3", ci=in_channels, co=ch[0],
                h=hs[0], w=ws[0]),
           dict(site="inc.conv2", kind="3x3", ci=ch[0], co=ch[0],
                h=hs[0], w=ws[0])]
    for i in range(4):
        out.append(dict(site=f"down{i + 1}.conv1", kind="3x3", ci=ch[i],
                        co=ch[i + 1], h=hs[i + 1], w=ws[i + 1]))
        out.append(dict(site=f"down{i + 1}.conv2", kind="3x3",
                        ci=ch[i + 1], co=ch[i + 1], h=hs[i + 1],
                        w=ws[i + 1]))
    for i in range(4):
        lvl = 3 - i                       # the skip's level
        cin = ch[lvl + 1]
        out.append(dict(site=f"up{i + 1}.up", kind="convT", ci=cin,
                        co=cin // 2, h=2 * hs[lvl + 1], w=2 * ws[lvl + 1]))
        out.append(dict(site=f"up{i + 1}.conv1", kind="3x3", ci=cin,
                        co=ch[lvl], h=hs[lvl], w=ws[lvl]))
        out.append(dict(site=f"up{i + 1}.conv2", kind="3x3", ci=ch[lvl],
                        co=ch[lvl], h=hs[lvl], w=ws[lvl]))
    return out


def _macs(s):
    """Multiply-adds of one conv on one frame. A transposed 2x2 stride-2
    conv gives each output pixel one tap: ci multiply-adds a pixel."""
    taps = 9 if s["kind"] == "3x3" else 1
    return taps * s["ci"] * s["co"] * s["h"] * s["w"]


def _in_pixels(s):
    return s["h"] * s["w"] // (1 if s["kind"] == "3x3" else 4)


def _wsize(s):
    return (9 if s["kind"] == "3x3" else 4) * s["ci"] * s["co"]


def site_precisions(cfg):
    """{site: (operand width, output width)} from a configuration:
    ``precision`` is the default; ``site_precision`` overrides a site's
    operands and ``site_output`` its output."""
    base = cfg["precision"]
    over = cfg.get("site_precision", {})
    outs = cfg.get("site_output", {})
    res = {}
    for name in SITE_NAMES:
        p = over.get(name, base)
        res[name] = (p, outs.get(name, p))
    return res


def conv_work(cfg, frames: int, *, train: bool):
    """Per call of the served step or the train step on ``frames`` frames:
    a list of dicts, one per conv pass, with ``site``, ``pass`` ("fwd",
    "dgrad", "wgrad"), ``precision``, ``ops`` and ``bytes``. The twin's
    two branches are counted as 2 x frames."""
    n = 2 * frames
    prec = site_precisions(cfg)
    out = []
    sites = branch_sites(cfg["in_channels"], cfg["base"],
                         cfg["input_hw"][0], cfg["input_hw"][1])
    for i, s in enumerate(sites):
        p, po = prec[s["site"]]
        b, bo = BYTES[p], BYTES[po]
        ops = 2 * _macs(s) * n
        x_el = n * _in_pixels(s) * s["ci"]
        y_el = n * s["h"] * s["w"] * s["co"]
        w_el = _wsize(s)
        out.append(dict(site=s["site"], pass_="fwd", precision=p, ops=ops,
                        bytes=x_el * b + w_el * b + y_el * bo))
        if train:
            out.append(dict(site=s["site"], pass_="wgrad", precision=p,
                            ops=ops, bytes=x_el * b + y_el * b + w_el * b))
            if i > 0:
                out.append(dict(site=s["site"], pass_="dgrad", precision=p,
                                ops=ops, bytes=y_el * b + w_el * b
                                + x_el * b))
    return out


def bound_seconds(work, peaks):
    """The least time the chip could take for ``work`` (a list from
    ``conv_work``): per pass the larger of its operations over its
    precision's peak and its bytes over the memory's, summed."""
    return sum(max(w["ops"] / peaks["flops_per_s"][_peak_key(w)],
                   w["bytes"] / peaks["bytes_per_s"]) for w in work)


def ideal_seconds(work, peaks):
    """Operations over their precision's peak, summed: the step's time at
    the peak, the denominator-free half of an MFU."""
    return sum(w["ops"] / peaks["flops_per_s"][_peak_key(w)] for w in work)


def _peak_key(w):
    return {"f32": "fp32", "i8": "int8"}.get(w["precision"], w["precision"])


def forward_ops_per_frame(cfg):
    """The twin forward's operations on one frame."""
    return sum(w["ops"] for w in conv_work(cfg, 1, train=False))
