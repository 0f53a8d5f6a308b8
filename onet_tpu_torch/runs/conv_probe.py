"""Cold-L2 timing of the forward conv kernel (``csrc/conv_wp.cu``, bf16)
in its main-path forms on one card, beside cuDNN's convolution on the same
inputs.

Forms (512x512, bf16): the BatchNorm-stats epilogue with one and two inputs
at the training shape (N=16 packed samples, bench.py's batch 8), the
bias+ReLU epilogue with one and two inputs at the serving shape (N=64,
batch 32), and the train step's input-gradient conv (one input, no
epilogue, flip-transposed taps, N=16).

It times the kernel of whichever ``onet_tpu_torch`` it imports, so two
trees of the package compare on one card, one process each: run this file
with ``PYTHONPATH`` set to the tree whose kernel is timed::

    PYTHONPATH=. python onet_tpu_torch/runs/conv_probe.py
    PYTHONPATH=path/to/other/tree python onet_tpu_torch/runs/conv_probe.py

Every call is timed with the L2 cache flushed before it, outside the CUDA
events (median of ``dw_probe.REPS``), by the profiler's device time and by
CUDA events with the card held behind a spin kernel (no host work counts
in either). The yardstick is ``F.conv2d`` on the unpacked
channels-last tensors: alone for the stats and dx forms (no PyTorch call
computes the statistics), with the bias for serving (no ReLU), the
two-input forms on a concat built outside the timing. The stats forms are
also held to their plain version (``rel_err``: y, s1, s2 over their largest
magnitude) and called twice (``deterministic``). Prints one JSON line.
"""

from __future__ import annotations

import json
import os

import torch

from onet_tpu_torch.runs.dw_probe import (PEAK_BF16_FLOP_S, PEAK_BYTES_S,
                                          card_line, cold_ms, device_ms,
                                          queued_ms)

H, W, C = 512, 512, 64
# name: (inputs, packed samples, epilogue)
FORMS = {
    "stats1": (1, 16, "stats"),
    "stats2": (2, 16, "stats"),
    "serve1": (1, 64, "bias_relu"),
    "serve2": (2, 64, "bias_relu"),
    "dx": (1, 16, None),
}


def bound(nin: int, n: int, epilogue) -> tuple:
    """(ms, 'bytes' | 'operations'): inputs, taps and bias read once, y (and
    s1, s2) written once, at the card's peaks."""
    act = n * H * W * C * 2
    nbytes = (nin + 1) * act + nin * 9 * C * C * 2 + 2 * C * 4
    if epilogue == "stats":
        nbytes += 2 * n * 2 * C * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 2 * n * H * W * C * C * 9 * nin / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(got, ref) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def run_form(TC, name: str, gen) -> dict:
    nin, n, epi = FORMS[name]
    dev = torch.device("cuda")
    xs = [torch.randn((n, H, W // 2, 2 * C), generator=gen, device=dev,
                      dtype=torch.bfloat16).clamp_min(0) for _ in range(nin)]
    w64 = [0.06 * torch.randn((3, 3, C, C), generator=gen, device=dev)
           for _ in range(nin)]
    bias = (0.1 * torch.randn(C, generator=gen, device=dev)).repeat(2)
    out = {"shape": [n, H, W, C], "inputs": nin, "epilogue": epi}
    if name == "dx":
        w = TC.flip_transpose(w64[0]).to(torch.bfloat16)
        kernel = lambda: TC._conv_w(xs, [w])
    else:
        wcs = [m for t in w64 for m in TC.make_wc_we(t, dtype=torch.bfloat16)]
        raw = TC.conv3x3_wp_raw if nin == 1 else TC.conv3x3_wp2_raw
        kw = dict(stats=True) if epi == "stats" else dict(bias=bias,
                                                          bias_relu=True)
        kernel = lambda: raw(*xs, *wcs, **kw)
        if epi == "stats":
            plain = TC.conv3x3_wp_plain if nin == 1 else TC.conv3x3_wp2_plain
            got = kernel()
            ref = plain(*xs, *wcs, stats=True, out_dtype=torch.float32)
            out["rel_err"] = [_rel(g, r) for g, r in zip(got, ref)]
            again = kernel()
            out["deterministic"] = all(torch.equal(a, b)
                                       for a, b in zip(got, again))
            del got, ref, again
    # cuDNN on the unpacked channels-last view ([N, H, W, 64] per input)
    x_lib = torch.cat([x.view(n, H, W, C) for x in xs], dim=-1).permute(
        0, 3, 1, 2)
    w_lib = torch.cat([t.to(torch.bfloat16) for t in
                       ([TC.flip_transpose(w64[0])] if name == "dx" else w64)],
                      dim=2).permute(3, 2, 0, 1).contiguous()
    b_lib = bias[:C].to(torch.bfloat16) if epi == "bias_relu" else None
    cudnn = lambda: torch.nn.functional.conv2d(x_lib, w_lib, b_lib, padding=1)
    for key, fn in (("kernel", kernel), ("cudnn", cudnn)):
        out[f"{key}_ms"] = cold_ms(fn)
        out[f"{key}_device_ms"] = device_ms(fn)
        out[f"{key}_queued_ms"] = queued_ms(fn)
    out["bound_ms"], out["bound_by"] = bound(nin, n, epi)
    out["kernel_share_of_bound"] = out["bound_ms"] / out["kernel_ms"]
    return out


def main() -> None:
    from onet_tpu_torch.ops import conv_wp as TC

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(torch.device("cuda")).manual_seed(1981)
    out = {
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(TC.__file__))),
        "card": card_line(),
    }
    for name in FORMS:
        out[name] = run_form(TC, name, gen)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
