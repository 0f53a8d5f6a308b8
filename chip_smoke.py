#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (onet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit; build the CUDA kernels from csrc/.
  2. kernels: each hand-written kernel against its plain PyTorch version at
     N=4, 512x512 (bf16 and f32): the conv with bias+ReLU on and off, the
     conv with the BatchNorm-stats epilogue (one and two inputs), the weight
     gradient; and at the shapes the main paths give them, bf16: the
     serving epilogue at the HTTP batch (8 frames -> N=16 packed samples),
     the stats epilogue and the weight gradient at the training batch
     (8 -> N=16). Then timed beside its plain version, a one-call library
     yardstick and its bound, each compared again on the inputs it is
     timed on: the serving epilogue at the serving shape of bench.py
     (batch 32 -> N=64), the stats epilogue and the weight gradient at the
     training shape.
  3. serving: the weight-shared Onet at full width (base 64, seeded random
     weights and BN statistics), BN-folded, behind the HTTP daemon on
     localhost, bf16, pair-packed path; 3 POST /segment requests of
     8 frames at 512^2, checked against direct calls, the stacked path and
     fp32; launch counts read around those requests; throughput.
  4. training: the same Onet (seeded random weights), bf16, batch 8,
     512^2, pair-packed path: 3 steps of make_train_step with Adam at
     lr 1e-5, launch counts read around them; against the stacked step
     (cuDNN only) from the same start, in fp32 at batch 2 (loss, gradient
     cosine) and bf16 at batch 8 (loss); step time and frames/s for both
     paths, a profiler breakdown and the peak memory of a pair-packed step;
     one make_eval_step call on labels thresholded from the frames.
The second-to-last line is the kernels JSON, the last the result JSON.
Exits non-zero without a CUDA device or without the port beside it.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 1981
H = W = 512
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM float32 outside the tensor cores
HBM = 3.35e12           # H100 SXM HBM3 bytes/s
# s1, s2 and dw against their plain versions, relative to their largest
# magnitude, f32 and bf16 inputs alike: both sum exact f32 products (bf16
# products are exact in f32) in another order, the [check] lines print by
# how much. One tile dropped or counted twice moves them by far more: a
# 4x32-pixel dw tile of the N=16 training batch by 3.1e-5 of dw, an
# 8x32-pixel conv tile by 9.8e-4 of its sample's s1/s2 at 512x512.
SUM_REL = 1e-5
KERNELS = {
    "conv3x3_wp": dict(nin=1, replaces="onet_tpu/ops/pallas_conv.py:212"),
    "conv3x3_wp2": dict(nin=2, replaces="onet_tpu/ops/pallas_conv.py:259"),
}
N_TRAIN = 16            # packed samples of bench.py's train batch of 8
TRAIN_STEPS = 3
LR = 1e-5               # bench.py's learning rate
# launches per pair-packed train step: 2 forward + 4 dx, 1, 4 dw
PER_STEP = {"conv3x3_wp": 6, "conv3x3_wp2": 1, "conv3x3_wp_dw": 4}


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nin: int, n: int, dtype, *, stats=False, dw=False) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time for the useful work of
    one call, inputs read once and outputs written once, 9 taps of 64x64
    per input. Conv: x (nin), taps and bias in, y (and s1, s2) out. Weight
    gradient: x and dy in, dw [3, 3, 64, 64] f32 out."""
    size = torch.tensor([], dtype=dtype).element_size()
    act = n * H * W * 64 * size
    if dw:
        nbytes = 2 * act + 9 * 64 * 64 * 4
    else:
        nbytes = (nin * act + act + nin * 9 * 64 * 64 * size + 128 * 4
                  + stats * 2 * n * 128 * 4)
    flops = 2 * n * H * W * 64 * 64 * 9 * nin
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def breakdown(fn, label: str, top: int = 10):
    """Device time by kernel over one call, from torch.profiler; the wall
    time includes the profiler's own cost."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"in {sum(e.count for e in kern)} kernels, idle share "
        f"{1 - busy / wall:.3f}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<3d} {e.key[:100]}")


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def kernel_inputs(TC, n, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((n, H, W // 2, 128), generator=g, dtype=dtype)
          .clamp_min(0).to(dev) for _ in range(2)]
    w64 = [0.06 * torch.randn((3, 3, 64, 64), generator=g) for _ in range(2)]
    ws = [tuple(t.to(dev) for t in TC.make_wc_we(w, dtype=dtype))
          for w in w64]
    bias = (0.1 * torch.randn(64, generator=g)).repeat(2).to(dev)
    return xs, ws, w64, bias


def call(TC, name, xs, ws, bias, plain=False, **kw):
    if name == "conv3x3_wp":
        fn = TC.conv3x3_wp_plain if plain else TC.conv3x3_wp_raw
        return fn(xs[0], *ws[0], bias=bias, **kw)
    fn = TC.conv3x3_wp2_plain if plain else TC.conv3x3_wp2_raw
    return fn(xs[0], xs[1], *ws[0], *ws[1], bias=bias, **kw)


def conv_err(TC, name, xs, ws, bias, tag, **kw) -> float:
    """One conv kernel against its plain version on the same inputs; raises
    on disagreement. y: f32 rtol/atol 1e-4 with TF32 off; bf16 inputs
    against the plain f32 accumulator, |err| <= 2e-2 * max|y| (one bf16
    rounding of the output). s1, s2 (stats=True): SUM_REL of their largest
    magnitude. Returns the largest absolute error of the outputs."""
    dtype = xs[0].dtype
    got = call(TC, name, xs, ws, bias, **kw)
    ref = call(TC, name, xs, ws, bias, plain=True, out_dtype=torch.float32,
               **kw)
    torch.cuda.synchronize()
    if not kw.get("stats"):
        got, ref = (got,), (ref,)
    y, ry = got[0], ref[0]
    if y.dtype != dtype or y.shape != ry.shape:
        raise AssertionError(f"{tag}: y {y.dtype} {tuple(y.shape)}")
    errs = [(y.float() - ry).abs().max().item()]
    scale = ry.abs().max().item()
    ok = (torch.allclose(y, ry, rtol=1e-4, atol=1e-4)
          if dtype == torch.float32 else errs[0] <= 2e-2 * scale)
    msg = [f"y {errs[0]:.3e} (max {scale:.3e})"]
    for label, s, r in zip(("s1", "s2"), got[1:], ref[1:]):
        err, top = (s - r).abs().max().item(), r.abs().max().item()
        ok = ok and err <= SUM_REL * top
        errs.append(err)
        msg.append(f"{label} {err:.3e} (max {top:.3e})")
    log(f"[check] {tag}: {', '.join(msg)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with its plain version")
    return max(errs)


def dw_err(TC, x, dy, tag) -> float:
    """conv3x3_wp_dw against its plain version: SUM_REL of max|dw|."""
    dw = TC.conv3x3_wp_dw(x, dy)
    ref = TC.conv3x3_wp_dw_plain(x, dy)
    torch.cuda.synchronize()
    err, top = (dw - ref).abs().max().item(), ref.abs().max().item()
    ok = err <= SUM_REL * top
    log(f"[check] {tag}: max_abs_err={err:.3e} max|dw|={top:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with its plain version")
    return err


def check_kernels(TC, dev) -> dict:
    """The serving epilogue (bias+ReLU on and off) at N=4 in f32 and bf16,
    and at the HTTP batch of the serving phase (8 frames -> N=16 packed) in
    bf16; the errors reported are those of the HTTP shape with bias+ReLU."""
    errs = {}
    for n, dtype in ((4, torch.float32), (4, torch.bfloat16),
                     (N_TRAIN, torch.bfloat16)):
        xs, ws, _, bias = kernel_inputs(TC, n, dtype, dev, seed=SEED + n)
        for name in KERNELS:
            for relu in (False, True):
                err = conv_err(TC, name, xs, ws, bias,
                               f"{name} N={n} {str(dtype)[6:]} "
                               f"bias_relu={relu}", bias_relu=relu)
                if n == N_TRAIN and relu:
                    errs[name] = err
        del xs
        torch.cuda.empty_cache()
    return errs


def check_train_kernels(TC, dev):
    """The stats epilogue (nin 1 and 2, no bias/ReLU, as training runs it)
    and dw at N=4, 512x512, in f32 and bf16. The training shape (N=16,
    bf16) is compared where it is timed, in time_train_kernels."""
    for dtype in (torch.float32, torch.bfloat16):
        xs, ws, _, _ = kernel_inputs(TC, 4, dtype, dev, seed=SEED + 2)
        for name in KERNELS:
            conv_err(TC, name, xs, ws, None,
                     f"{name}+stats N=4 {str(dtype)[6:]}", stats=True)
        dw_err(TC, xs[0], xs[1], f"conv3x3_wp_dw N=4 {str(dtype)[6:]}")


def time_train_kernels(TC, dev) -> tuple:
    """Training shape: N=16 packed samples (bench.py's batch 8), bf16. Each
    kernel is first compared with its plain version on the inputs it is
    timed on; those errors go into the kernels line.
    Library yardsticks, never called by the port: for conv+stats cuDNN's
    conv alone (no call computes the conv with its statistics); for dw
    cuDNN's weight gradient (aten.convolution_backward, output mask
    [False, False, True]) on the unpacked channels-last tensors."""
    n, dtype = N_TRAIN, torch.bfloat16
    xs, ws, w64, _ = kernel_inputs(TC, n, dtype, dev, seed=SEED + 3)
    out, errs = {}, {}
    unpacked = [x.reshape(n, H, W, 64).permute(0, 3, 1, 2) for x in xs]
    for name, meta in KERNELS.items():
        nin = meta["nin"]
        errs[name + "+stats"] = conv_err(TC, name, xs, ws, None,
                                         f"{name}+stats N={n} bf16",
                                         stats=True)
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: call(TC, name, xs, ws, None, stats=True))
        plain_ms = cuda_ms(lambda: call(TC, name, xs, ws, None, plain=True,
                                        stats=True), reps=3, warmup=1)
        torch.cuda.empty_cache()
        x_lib = torch.cat(unpacked[:nin], dim=1) if nin > 1 else unpacked[0]
        w_lib = torch.cat([w.to(dev, dtype) for w in w64[:nin]], dim=2)
        w_lib = w_lib.permute(3, 2, 0, 1).contiguous()
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            x_lib, w_lib, padding=1))
        del x_lib
        torch.cuda.empty_cache()
        b_ms, b_by = bound(nin, n, dtype, stats=True)
        out[name + "+stats"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, library_call="F.conv2d alone (cuDNN), no stats")
        log(f"[time] {name}+stats N={n} {H}x{W} bf16: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, cuDNN conv alone {lib_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by})")
    x, dy = xs
    errs["conv3x3_wp_dw"] = dw_err(TC, x, dy, f"conv3x3_wp_dw N={n} bf16")
    ms = cuda_ms(lambda: TC.conv3x3_wp_dw(x, dy))
    plain_ms = cuda_ms(lambda: TC.conv3x3_wp_dw_plain(x, dy), reps=3,
                       warmup=1)
    torch.cuda.empty_cache()
    w_lib = w64[0].to(dev, dtype).permute(3, 2, 0, 1).contiguous()
    lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
        unpacked[1], unpacked[0], w_lib, None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, [False, False, True]))
    b_ms, b_by = bound(1, n, dtype, dw=True)
    out["conv3x3_wp_dw"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by, library_call="aten.convolution_backward, dw only")
    log(f"[time] conv3x3_wp_dw N={n} {H}x{W} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, cuDNN weight gradient {lib_ms:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by})")
    return out, errs


def time_kernels(TC, dev) -> dict:
    """Serving shape: N=64 packed samples (bench.py's batch 32), bf16, each
    kernel first compared with its plain version on the inputs it is timed
    on."""
    n, dtype = 64, torch.bfloat16
    xs, ws, w64, bias = kernel_inputs(TC, n, dtype, dev, seed=SEED + 1)
    out = {}
    for name, meta in KERNELS.items():
        nin = meta["nin"]
        conv_err(TC, name, xs, ws, bias, f"{name} N={n} bf16 bias_relu=True",
                 bias_relu=True)
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: call(TC, name, xs, ws, bias, bias_relu=True))
        plain_ms = cuda_ms(lambda: call(TC, name, xs, ws, bias, plain=True,
                                        bias_relu=True), reps=3, warmup=1)
        torch.cuda.empty_cache()
        # library yardstick: cuDNN conv + bias on the unpacked channels-last
        # tensor (the two-input form on a concat built outside the timing)
        x_lib = torch.cat([x.reshape(n, H, W, 64) for x in xs[:nin]],
                          dim=-1).permute(0, 3, 1, 2)
        w_lib = torch.cat([w.to(dev, dtype) for w in w64[:nin]], dim=2)
        w_lib = w_lib.permute(3, 2, 0, 1).contiguous()
        b_lib = bias[:64].to(dtype)
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            x_lib, w_lib, b_lib, padding=1))
        del x_lib
        torch.cuda.empty_cache()
        b_ms, b_by = bound(nin, n, dtype)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        log(f"[time] {name} N={n} {H}x{W} bf16: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound {b_ms:.3f} "
            f"ms ({b_by})")
    return out


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def frames(n: int, seed: int) -> np.ndarray:
    """Smooth clutter plus a few bright blobs, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.empty((n, H, W, 1), np.float32)
    for i in range(n):
        img = 0.3 + 0.1 * rng.standard_normal((H, W)).astype(np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            r = rng.uniform(8, 40)
            img += 0.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                / (2 * r * r))
        out[i, ..., 0] = np.clip(img, 0, 1)
    return out


def post(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()))


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def serve(TC, dev) -> dict:
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import param_count
    from onet_tpu_torch.serve.http import ServingSession, start_server

    gen = torch.Generator().manual_seed(SEED)
    params, state = onet_init(gen, 1, base=64)
    # non-trivial running statistics, so folding is exercised
    def perturb(tree):
        if "var" in tree:
            c = tree["var"].shape
            return {"mean": (0.1 * torch.randn(c, generator=gen)).to(dev),
                    "var": (0.5 + torch.rand(c, generator=gen)).to(dev)}
        return {k: perturb(v) for k, v in tree.items()}

    state = perturb(state)
    folded = fold_onet(params, state)
    log(f"[serve] Onet base 64, {param_count(params)} params, seed {SEED}")

    def step(f, xb):
        return onet_infer(f, xb, policy=BF16_COMPUTE, pair_pack=True)

    batch = 8
    sess = ServingSession(step, folded, batch=batch, in_channels=1,
                          mode="bf16", model_name=f"random-seed-{SEED}",
                          input_hw=(H, W))
    sess.warmup()
    httpd = start_server(sess, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    reqs = [frames(batch, SEED + 10 + i) for i in range(3)]
    try:
        TC.conv3x3_wp_raw.launches = 0
        TC.conv3x3_wp2_raw.launches = 0
        masks = [post(url + "/segment", r) for r in reqs]
        launches = {"conv3x3_wp": TC.conv3x3_wp_raw.launches,
                    "conv3x3_wp2": TC.conv3x3_wp2_raw.launches}
        health = get_json(url + "/healthz")
        stats = get_json(url + "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    if th.is_alive():
        raise AssertionError("HTTP server thread did not stop")
    log(f"[serve] launches in 3 requests: {launches}; healthz {health}; "
        f"stats {stats}")
    if launches != {"conv3x3_wp": 2 * 3, "conv3x3_wp2": 1 * 3}:
        raise AssertionError(f"kernel launches {launches}, expected 6 and 3")
    if health["status"] != "ok" or stats["requests"] != 3 or \
            stats["frames"] != 3 * batch:
        raise AssertionError("healthz/stats disagree with the requests")

    agree = []
    with torch.inference_mode():
        for r, m in zip(reqs, masks):
            x = torch.from_numpy(r).to(dev)
            s, lab = step(folded, x)
            if m.shape != (batch, H, W) or m.dtype != np.uint8:
                raise AssertionError(f"response {m.shape} {m.dtype}")
            if not torch.isfinite(s).all():
                raise AssertionError("non-finite S")
            if not np.array_equal(m, lab.cpu().numpy().astype(np.uint8)):
                raise AssertionError("HTTP masks differ from onet_infer")
            _, lab_st = onet_infer(folded, x, policy=BF16_COMPUTE,
                                   pair_pack=False)
            agree.append(float((lab_st == lab).float().mean()))
        fg = float(np.mean([m.mean() for m in masks]))
        log(f"[serve] wp vs stacked bf16 mask agreement {agree}; "
            f"foreground share {fg:.4f}")
        if min(agree) < 0.99:
            raise AssertionError(f"wp/stacked agreement {min(agree)} < 0.99")

        x2 = torch.from_numpy(reqs[0][:2]).to(dev)
        s_wp, _ = onet_infer(folded, x2, policy=DEFAULT, pair_pack=True)
        s_st, _ = onet_infer(folded, x2, policy=DEFAULT, pair_pack=False)
        d32 = (s_wp - s_st).abs().max().item()
        log(f"[serve] fp32 batch 2: max |S_wp - S_stacked| = {d32:.3e}")
        if not d32 <= 1e-3:
            raise AssertionError(f"fp32 wp/stacked S differ by {d32}")

        perf = {"http_request_ms_p50": stats["total_ms"]["p50"]}
        for b in (8, 32):
            xb = torch.from_numpy(
                np.concatenate([reqs[0]] * (b // batch))).to(dev)
            for wp in (True, False):
                ms = cuda_ms(lambda: onet_infer(
                    folded, xb, policy=BF16_COMPUTE, pair_pack=wp),
                    reps=5, warmup=2)
                key = f"b{b}_{'wp' if wp else 'stacked'}"
                perf[key + "_step_ms"] = ms
                perf[key + "_frames_per_s"] = b / ms * 1e3
                if b == batch:
                    breakdown(lambda: onet_infer(
                        folded, xb, policy=BF16_COMPUTE, pair_pack=wp),
                        f"batch {b} {'wp' if wp else 'stacked'} step")
                torch.cuda.empty_cache()
    return dict(launches=launches, agreement=min(agree), fp32_s_diff=d32,
                **perf)


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def _clone(tree):
    from onet_tpu_torch.models.unet import tree_map
    return tree_map(torch.clone, tree)


def _loss_and_grads(params, state, x, policy, pair_pack):
    """Loss and the flat gradient of one training forward."""
    from onet_tpu_torch.models.onet import compute_loss, onet_forward
    from onet_tpu_torch.models.unet import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with policy.precision():
        out, _ = onet_forward(p, _clone(state), x, train=True, policy=policy,
                              pair_pack=pair_pack)
        loss = compute_loss(out)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.item(), torch.cat([g.reshape(-1).double() for g in grads])


def train(TC, dev) -> dict:
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.models.unet import tree_leaves
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_eval_step, make_train_step

    gen = torch.Generator().manual_seed(SEED + 20)
    params0, state0 = O.onet_init(gen, 1, base=64)
    batch = 8
    xs = [torch.from_numpy(frames(batch, SEED + 30 + i)).to(dev)
          for i in range(TRAIN_STEPS)]

    # the main path: bench.py's step (ONET_PAIR_PACK=1), pair-packed
    O.PAIR_PACK = True
    step = make_train_step(policy=BF16_COMPUTE)
    params, state, opt = _clone(params0), _clone(state0), adam_init(params0)
    for k in ("conv3x3_wp_raw", "conv3x3_wp2_raw", "conv3x3_wp_dw"):
        setattr(getattr(TC, k), "launches", 0)
    TC.conv3x3_wp_raw.stats_launches = TC.conv3x3_wp2_raw.stats_launches = 0
    losses = []
    for x in xs:
        params, state, opt, loss = step(params, state, opt, x, LR)
        losses.append(loss.item())
    launches = {"conv3x3_wp": TC.conv3x3_wp_raw.launches,
                "conv3x3_wp2": TC.conv3x3_wp2_raw.launches,
                "conv3x3_wp_dw": TC.conv3x3_wp_dw.launches,
                "conv3x3_wp+stats": TC.conv3x3_wp_raw.stats_launches,
                "conv3x3_wp2+stats": TC.conv3x3_wp2_raw.stats_launches}
    log(f"[train] wp bf16 batch {batch}: losses {losses}; launches in "
        f"{TRAIN_STEPS} steps {launches}")
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    want.update({"conv3x3_wp+stats": 2 * TRAIN_STEPS,
                 "conv3x3_wp2+stats": TRAIN_STEPS})
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError("non-finite parameter after training")
    moved = sum(not torch.equal(a, b) for a, b in
                zip(tree_leaves(state), tree_leaves(state0)))
    log(f"[train] BN running-stat leaves moved: {moved} of "
        f"{len(tree_leaves(state))}")
    if moved != len(tree_leaves(state)):
        raise AssertionError("BatchNorm running stats did not all move")

    # the stacked step (cuDNN only) from the same start, bf16 batch 8
    O.PAIR_PACK = False
    step_st = make_train_step(policy=BF16_COMPUTE)
    _, _, _, loss_st = step_st(_clone(params0), _clone(state0),
                               adam_init(params0), xs[0], LR)
    bf16_rel = abs(loss_st.item() - losses[0]) / abs(losses[0])
    log(f"[train] bf16 batch {batch} first-step loss: wp {losses[0]:.6f}, "
        f"stacked {loss_st.item():.6f}, relative difference {bf16_rel:.3e}")
    if not bf16_rel <= 1e-2:
        raise AssertionError(f"bf16 wp/stacked loss differ by {bf16_rel}")

    # fp32 batch 2: loss within 1e-4, gradient cosine > 0.9999 (the JAX
    # package's wp-vs-stacked contract, tests/test_wp_path.py)
    x2 = xs[0][:2]
    l_wp, g_wp = _loss_and_grads(params0, state0, x2, DEFAULT, True)
    l_st, g_st = _loss_and_grads(params0, state0, x2, DEFAULT, False)
    cos = float((g_wp @ g_st) / (g_wp.norm() * g_st.norm()))
    rel_g = float((g_wp - g_st).norm() / g_st.norm())
    l_rel = abs(l_wp - l_st) / abs(l_st)
    log(f"[train] fp32 batch 2: loss wp {l_wp:.7f} stacked {l_st:.7f} "
        f"(relative {l_rel:.3e}); gradient cosine {cos:.7f}, relative L2 "
        f"{rel_g:.3e}")
    if not (l_rel <= 1e-4 and cos > 0.9999):
        raise AssertionError("fp32 wp/stacked train paths disagree")
    del g_wp, g_st

    # step time (CUDA events, median of 5 after 2 warm-ups), frames/s
    perf = {}
    for wp in (True, False):
        O.PAIR_PACK = wp
        fn_step = make_train_step(policy=BF16_COMPUTE)
        p, st, o = _clone(params0), _clone(state0), adam_init(params0)
        ms = cuda_ms(lambda: fn_step(p, st, o, xs[0], LR))
        key = "wp" if wp else "stacked"
        perf[f"train_b{batch}_{key}_step_ms"] = ms
        perf[f"train_b{batch}_{key}_frames_per_s"] = batch / ms * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn_step(p, st, o, xs[0], LR)
        torch.cuda.synchronize()
        perf[f"train_b{batch}_{key}_peak_gib"] = (
            torch.cuda.max_memory_allocated() / 2 ** 30)
        if wp:
            breakdown(lambda: fn_step(p, st, o, xs[0], LR),
                      f"train step batch {batch} wp", top=14)
        log(f"[train] {key} bf16 batch {batch}: step {ms:.2f} ms, "
            f"{batch / ms * 1e3:.1f} frames/s, peak "
            f"{perf[f'train_b{batch}_{key}_peak_gib']:.2f} GiB")
        del p, st, o
        torch.cuda.empty_cache()

    # one eval step on the trained weights, labels from the frames' blobs
    O.PAIR_PACK = True
    labels = (xs[0][..., 0] > 0.6).to(torch.int32)
    metrics, loss_ev, pred = make_eval_step(policy=BF16_COMPUTE)(
        params, state, xs[0], labels)
    metrics = {k: float(v) for k, v in metrics.items()}
    log(f"[train] eval step: loss {loss_ev.item():.6f}, metrics {metrics}, "
        f"label share {float(labels.float().mean()):.4f}")
    if pred.shape != (batch, H, W) or not np.isfinite(loss_ev.item()) or \
            not all(0.0 <= v <= 1.0 for v in metrics.values()):
        raise AssertionError(f"eval step output off: {metrics}")
    O.PAIR_PACK = False
    return dict(launches=launches, losses=losses, bf16_loss_rel=bf16_rel,
                fp32_loss_rel=l_rel, fp32_grad_cos=cos, fp32_grad_rel=rel_g,
                eval=metrics, **perf)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the "
              "card", file=sys.stderr)
        return 2
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.ops import _build
    from onet_tpu_torch.ops import conv_wp as TC

    dev = resolve_device()
    card = card_line()
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); nvidia-smi name, "
        f"power.limit:")
    log(card)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels(TC, dev)
    check_train_kernels(TC, dev)
    times = time_kernels(TC, dev)
    torch.cuda.empty_cache()
    train_times, train_errs = time_train_kernels(TC, dev)
    times.update(train_times)
    errs.update(train_errs)
    torch.cuda.empty_cache()
    served = serve(TC, dev)
    log("[serve] " + json.dumps(served))
    log(f"[serve] 512x512 batch 8, bf16, pair-packed: "
        f"{served['b8_wp_frames_per_s']:.1f} frames/s, step p50 "
        f"{served['b8_wp_step_ms']:.2f} ms, HTTP request p50 "
        f"{served['http_request_ms_p50']:.2f} ms on {card}")
    torch.cuda.empty_cache()
    trained = train(TC, dev)
    log("[train] " + json.dumps(trained))
    log(f"[train] 512x512 batch 8, bf16, Adam: pair-packed "
        f"{trained['train_b8_wp_frames_per_s']:.1f} frames/s, stacked "
        f"{trained['train_b8_stacked_frames_per_s']:.1f} frames/s on {card}")

    rows = []
    for name, meta in KERNELS.items():
        rows.append(dict(
            name=name, route="cuda", source="onet_tpu_torch/csrc/conv_wp.cu",
            replaces=meta["replaces"], launches=served["launches"][name],
            max_abs_err=errs[name], max_err=errs[name], **times[name]))
    for name, meta in KERNELS.items():
        key = name + "+stats"
        rows.append(dict(
            name=key, route="cuda", source="onet_tpu_torch/csrc/conv_wp.cu",
            replaces=meta["replaces"], launches=trained["launches"][key],
            max_abs_err=errs[key], **times[key]))
    rows.append(dict(
        name="conv3x3_wp_dw", route="cuda",
        source="onet_tpu_torch/csrc/conv_wp_dw.cu",
        replaces="onet_tpu/ops/pallas_conv.py:457",
        launches=trained["launches"]["conv3x3_wp_dw"],
        max_abs_err=errs["conv3x3_wp_dw"], **times["conv3x3_wp_dw"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
