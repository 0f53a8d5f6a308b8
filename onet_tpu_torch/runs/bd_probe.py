"""Cold-L2 timing of the native-layout conv kernel (``csrc/conv_bd.cu``) in
both forms at the bd probe's sites (N=8, 512x512, 128 -> 128 lanes, bf16,
with the BatchNorm-stats epilogue) on one card, beside cuDNN on the same
inputs.

It times the kernel of whichever ``onet_tpu_torch`` it imports, so two
trees of the package compare on one card, one process each: run this file
with ``PYTHONPATH`` set to the tree whose kernel is timed::

    PYTHONPATH=. python onet_tpu_torch/runs/bd_probe.py
    PYTHONPATH=path/to/other/tree python onet_tpu_torch/runs/bd_probe.py

It imports only names every tree of the port since the bd kernel has:
``ops.conv_bd`` and ``runs.dw_probe``'s timers. Every call is timed with
the L2 cache flushed before it, outside the CUDA events (median of
``dw_probe.REPS``), and by the profiler's device time (no host work
counts). Beside the kernel: cuDNN's conv alone (``F.conv2d``, the two-input
form on a concat built outside the timing) and the library formulation of
the fused epilogue, cuDNN's conv then a separate f32 stats pass
(``conv_stats_library``). The kernel is held to its plain version
(``rel_err``: y, s1, s2 over their largest magnitude) and called twice
(``deterministic``: s1, s2 bit-identical). Prints one JSON line.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F

from onet_tpu_torch.runs.dw_probe import (PEAK_BF16_FLOP_S, PEAK_BYTES_S,
                                          card_line, cold_ms, device_ms)

N, H, W, L = 8, 512, 512, 128


def bound(nin: int) -> tuple:
    """(ms, 'bytes' | 'operations'): inputs and taps read once, y, s1, s2
    written once, at the card's peaks."""
    nbytes = ((nin + 1) * N * H * W * L * 2 + nin * 9 * L * L * 2
              + 2 * N * L * 4)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 2 * N * H * W * L * L * 9 * nin / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(got, ref) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def run_form(BD, nin: int, gen) -> dict:
    dev = torch.device("cuda")
    xs = [(0.1 * torch.randn((N, H, W, L), generator=gen, device=dev))
          .to(torch.bfloat16) for _ in range(nin)]
    ws = [(0.05 * torch.randn((3, 3, L, L), generator=gen, device=dev))
          .to(torch.bfloat16) for _ in range(nin)]
    raw = BD.conv3x3_bd_raw if nin == 1 else BD.conv3x3_bd2in_raw
    plain = BD.conv3x3_bd_plain if nin == 1 else BD.conv3x3_bd2in_plain
    kernel = lambda: raw(*xs, *ws, stats=True)
    out = {"shape": [N, H, W, L], "inputs": nin}
    got = kernel()
    ref = plain(*xs, *ws, stats=True, out_dtype=torch.float32)
    out["rel_err"] = [_rel(g, r) for g, r in zip(got, ref)]
    again = kernel()
    out["deterministic"] = all(torch.equal(a, b)
                               for a, b in zip(got[1:], again[1:]))
    del got, ref, again
    torch.cuda.empty_cache()
    x_cat = torch.cat(xs, dim=-1)
    w_cat = torch.cat(ws, dim=2)
    x_lib = x_cat.permute(0, 3, 1, 2)
    w_lib = w_cat.permute(3, 2, 0, 1).contiguous()
    cudnn = lambda: F.conv2d(x_lib, w_lib, padding=1)
    library = lambda: BD.conv_stats_library(x_cat, w_cat)
    for key, fn in (("kernel", kernel), ("cudnn", cudnn),
                    ("library_conv_plus_stats", library)):
        out[f"{key}_ms"] = cold_ms(fn)
        out[f"{key}_device_ms"] = device_ms(fn)
    out["bound_ms"], out["bound_by"] = bound(nin)
    out["kernel_share_of_bound"] = out["bound_ms"] / out["kernel_device_ms"]
    return out


def main() -> None:
    from onet_tpu_torch.ops import conv_bd as BD

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(torch.device("cuda")).manual_seed(1981)
    out = {
        "tree": os.path.dirname(os.path.dirname(os.path.abspath(BD.__file__))),
        "card": card_line(),
    }
    for name, nin in (("one_input", 1), ("two_inputs", 2)):
        out[name] = run_form(BD, nin, gen)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
