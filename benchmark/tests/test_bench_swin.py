"""The Swin-Unet cell's pieces: device time by span (``regions.py``) on a
synthetic trace, its readers on records without spans or counters, the
new kernel classes against the kernels of the cells before them, the
reference's imports, and a tiny run of the cell on the CPU."""

import glob
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import harness, regions, trace

SWIN = "swinunet-t-bf16.train-224-b64"
SEED = 2 ** 32 + 101
NEW_METRICS = ("window_attn_share.train-swin", "norm_share.train-swin",
               "window_attn_us.train-swin", "gemm_roofline.train-swin")
# the kernels the four cells before these ran most (their breakdowns as
# the ledger keeps them: 64 characters, punctuation as "_"), and some
# names as the profiler writes them
EARLIER_KERNELS = [
    "Memcpy_HtoD__Pageable_-__Device_",
    "_anonymous_namespace_::conv_i8_128__false__CUtensorMap_st__CUten",
    "at::native::_anonymous_namespace_::CatArrayBatchedCopy_vectorize",
    "at::native::_anonymous_namespace_::max_pool_forward_nhwc_c10::BF",
    "at::native::elementwise_kernel_128__2__at::native::gpu_kernel_im",
    "at::native::elementwise_kernel_128__4__at::native::gpu_kernel_im",
    "at::native::reduce_kernel_128__4__at::native::ReduceOp_float__at",
    "at::native::reduce_kernel_128__4__at::native::ReduceOp_signed_ch",
    "at::native::reduce_kernel_512__1__at::native::ReduceOp_float__at",
    "at::native::unrolled_elementwise_kernel_at::native::direct_copy_",
    "at::native::vectorized_elementwise_kernel_4__at::native::BinaryF",
    "at::native::vectorized_elementwise_kernel_4__at::native::CUDAFun",
    "at::native::vectorized_elementwise_kernel_4__at::native::_anonym",
    "at::native::vectorized_elementwise_kernel_4__at::native::round_k",
    "at::native::vectorized_elementwise_kernel_8__at::native::_anonym",
    "at::native::vectorized_elementwise_kernel_8__at::native::bfloat1",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float>",
    "splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float>",
    "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pinned)",
    "Memcpy DtoD (Device -> Device)", "Memset (Device)",
]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def _kernel(corr, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def test_regions_attribute_launches_by_span_and_by_forward_op():
    ev = [
        # forward on thread 1: a span around an op with sequence number 5
        # and a nested span around a second launch
        _x("user_annotation", "swin.window_attention", 100, 50),
        _x("cpu_op", "aten::mm", 110, 10, **{"Sequence number": 5,
                                              "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 112, 2, correlation=1),
        _x("user_annotation", "layer_norm", 130, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 132, 2, correlation=2),
        # a launch outside every span
        _x("cuda_runtime", "cudaLaunchKernel", 200, 2, correlation=3),
        # backward on thread 2: the node made by op 5
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
           300, 20, tid=2, **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("cuda_runtime", "cuLaunchKernelEx", 305, 2, tid=2,
           correlation=4),
        # a backward node whose forward ran in no span
        _x("cpu_op", "MulBackward0", 330, 10, tid=2,
           **{"Sequence number": 9, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 332, 2, tid=2,
           correlation=5),
    ] + [_kernel(c, d) for c, d in ((1, 10.0), (2, 3.0), (3, 7.0),
                                    (4, 20.0), (5, 1.0))]
    got = regions.reduce(ev)
    assert got == pytest.approx({"swin.window_attention": 30e-6,
                                 "layer_norm": 3e-6})


def test_regions_are_empty_without_spans():
    ev = [_x("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
          _kernel(1, 5.0)]
    assert regions.reduce(ev) == {}


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_readers_give_none_without_spans_or_counters(metric):
    rd = harness.reader(metric)
    base = {"kind": "train", "calls": 3, "peaks": harness.peaks(),
            "work": [], "summary": {"device_s": 1.0, "window_s": 1.0,
                                    "by_class": {"conv": 1.0}}}
    assert rd.read({"kind": "serve"}) is None
    assert rd.read(dict(base)) is None
    assert rd.read(dict(base, regions={}, counters={})) is None


def test_readers_on_a_record_with_spans():
    from benchmark.work.swin_unet import product_work
    cfg = harness.load_config(harness.find_cell(
        harness.load_benchmark(), SWIN)[1])
    rec = {"kind": "train", "calls": 2, "peaks": harness.peaks(),
           "work": product_work(cfg, 64, train=True),
           "summary": {"device_s": 2.0, "window_s": 2.5,
                       "by_class": {"gemm": 0.5, "pointwise": 1.5}},
           "regions": {"swin.window_attention": 0.5, "layer_norm": 0.25},
           "counters": {"swin.windows": 2 * 43264}}
    read = {m: harness.reader(m).read(rec) for m in NEW_METRICS}
    assert read["window_attn_share.train-swin"] == 0.25
    assert read["norm_share.train-swin"] == 0.125
    assert read["window_attn_us.train-swin"] == pytest.approx(
        0.5e6 / 86528)
    assert 0 < read["gemm_roofline.train-swin"] < 100


def test_new_kernel_classes_leave_the_earlier_kernels_in_their_class():
    new = {"conv.swin.json", "gemm.json", "pointwise.foreach.json",
           "pointwise.swin.json"}
    paths = sorted(glob.glob(os.path.join(harness.BENCH_DIR, "kernels",
                                          "*.json")))
    assert new <= {os.path.basename(p) for p in paths}
    old = []
    for path in paths:
        if os.path.basename(path) in new:
            continue
        spec = json.load(open(path))
        old += [(spec["class"], re.compile(p)) for p in spec["patterns"]]
    every = trace.kernel_classes(harness.BENCH_DIR)
    for name in EARLIER_KERNELS:
        assert trace.classify(name, every) == trace.classify(name, old), name
    for name, cls in (("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "gemm"),
                      ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize",
                       "gemm"),
                      ("void at::native::roll_cuda_kernel<float>",
                       "pointwise"),
                      ("void (anonymous namespace)::cunn_SoftMaxForward<4>",
                       "pointwise"),
                      ("void at::native::(anonymous namespace)::"
                       "multi_tensor_apply_kernel<at::native::(anonymous "
                       "namespace)::TensorListMetadata<2>", "pointwise"),
                      ("void convolve_common_engine_float_NHWC<__nv_bfloat16>",
                       "conv")):
        assert trace.classify(name, every) == cls, name


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys\nsys.path.insert(0, {root!r})\n"
            "import benchmark.reference.swin_unet, benchmark.work.swin_unet\n"
            "import benchmark.inputs.swin_weights, benchmark.regions\n"
            "print(json.dumps(sorted({{n.split('.')[0] for n in "
            "sys.modules}})))\n").format(root=harness.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT, env=env,
                         timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"onet_tpu_torch", "onet_tpu", "jax", "jaxlib"}, tops


def _tiny(cell):
    bench = harness.load_benchmark()
    wl, ce = harness.find_cell(bench, cell)
    cfg, mix = harness.load_config(ce), harness.load_mix(wl["traffic"])
    cfg.update(swin_window=2, swin_embed=12, input_hw=[64, 64])
    # the CPU bf16 readings at this size (tests/
    # test_torch_swin_reference.py), with room
    cfg["limits"] = {"train": {"loss": 1e-3, "grad": 0.05, "change": 0.08}}
    mix.update(pool=16, epochs=4, batch=4)
    return bench, cfg, mix


def test_a_tiny_swin_run_is_correct_and_counts_its_windows():
    bench, cfg, mix = _tiny(SWIN)
    drv = harness.driver(mix["driver"])
    ctx = harness.Context(cell=SWIN, cfg=cfg, mix=mix, seed=SEED,
                          seconds=0.2, trace=False,
                          device=torch.device("cpu"), tmpdir="/tmp")
    st = drv.setup(ctx)
    rec = drv.window(ctx, st)
    # 4 frames, 8 images through the twin, 338 windows (168 shifted) each
    assert rec["counters"]["swin.windows"] == rec["calls"] * 8 * 338
    assert rec["counters"]["swin.shifted_windows"] == rec["calls"] * 8 * 168
    assert harness.judge(drv.check(ctx, st, rec))


def test_a_tiny_swin_run_without_the_seam_mask_is_caught(monkeypatch):
    import onet_tpu_torch.models.swin as S
    sound = S._shift_mask_on
    monkeypatch.setattr(S, "_shift_mask_on",
                        lambda *a: torch.zeros_like(sound(*a)))
    bench, cfg, mix = _tiny(SWIN)
    drv = harness.driver(mix["driver"])
    ctx = harness.Context(cell=SWIN, cfg=cfg, mix=mix, seed=SEED,
                          seconds=0.2, trace=False,
                          device=torch.device("cpu"), tmpdir="/tmp")
    st = drv.setup(ctx)
    rec = drv.window(ctx, st)
    assert not harness.judge(drv.check(ctx, st, rec))
