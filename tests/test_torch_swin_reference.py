"""The port's Swin-Unet Onet (``models/swin.py``) against the benchmark's
plain float32 reference (``benchmark/reference/swin_unet.py``), on the
CPU, on seeded weights (``benchmark/inputs/swin_weights.py``).

At 64^2 with window 2 and embed 12 the stage sides are 16, 8, 4 and 2, so
the shifted windows, their seam mask and the relative-position bias are
live in the first three stages, as at 224^2 with window 7. Also: the
spans and counters of one forward at the published geometry, and the
benchmark's work count (``benchmark/work/swin_unet.py``) against
``FlopCounterMode``'s count of that forward.
"""

import collections
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.drivers.train import batch_order  # noqa: E402
from benchmark.inputs import swin_weights as W  # noqa: E402
from benchmark.reference import swin_unet as R  # noqa: E402
from benchmark.traffic import frames  # noqa: E402
from benchmark.work import swin_unet as SW  # noqa: E402
from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT  # noqa: E402
from onet_tpu_torch.models.arch import get_arch  # noqa: E402
from onet_tpu_torch.models.onet import compute_loss  # noqa: E402
from onet_tpu_torch.models.swin import swin_onet_forward  # noqa: E402
from onet_tpu_torch.train.optim import adam_init  # noqa: E402
from onet_tpu_torch.train.steps import make_train_step  # noqa: E402
from onet_tpu_torch.utils import profiling  # noqa: E402

SEED = 2 ** 33 + 23
LR = 5e-6
TINY = dict(in_channels=1, swin_embed=12, swin_window=2, depths=[2, 2, 2, 2],
            heads=[3, 6, 12, 24], mlp_ratio=4, out_dim=64)
PUBLISHED = dict(TINY, swin_embed=96, swin_window=7, input_hw=[224, 224],
                 precision="bf16")
POLICIES = {"fp32": DEFAULT, "bf16": BF16_COMPUTE}
# bf16 tolerances. Every linear's operands and output, the LayerNorms'
# outputs and the residual stream are rounded to 8 bits of mantissa
# (2^-9 relative each) through 14 blocks and the decoder, against a
# float32 reference: the logits V then differ by ~2% of their largest
# value (1.8-2.3% read here), the loss by ~2e-4 of itself. The train
# readings are the benchmark's (``drivers/train_family.py::readings``):
# the worst leaf's step-1 gradient norm read 0.011 and its 3-step change
# 0.018 here; the limits leave 3-4x room and stay below the faults'
# readings (no seam mask 0.13 / 0.14, no bias table change 1.0).
BF16_V = 0.06
BF16_LOSS = 1e-3
BF16_TRAIN = {"loss": 1e-3, "grad": 0.05, "change": 0.08}
# float32: the same arithmetic in another order (a fused LayerNorm against
# the port's two passes, q scaled before the product, the skip fusion as
# two products): ~1e-6 of V and the gradients' scale; Adam divides each
# update by the root of the gradient's second moment, so an element with a
# gradient near zero may move by another fraction of lr: the change reads
# up to ~2e-4.
FP32_TRAIN = {"loss": 1e-5, "grad": 1e-4, "change": 2e-3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(cfg=TINY):
    return W.make(SEED, cfg, torch.device("cpu"))


@pytest.fixture(scope="module")
def batches():
    pool = frames.make_pool(SEED, 16, [64, 64], device=torch.device("cpu"))
    order = torch.as_tensor(batch_order(SEED, 16, 4, 1))
    return [pool[order[i]] for i in range(3)]


@pytest.fixture(scope="module")
def reference(batches):
    p0, _ = _weights()
    return R.train_steps(p0, batches, LR, window=2)


def _program_first(batches, policy):
    """The program's three train steps: losses, step-1 gradient norms
    (Adam's mu / (1 - b1)) and each leaf's change."""
    fwd = get_arch("swin", swin_window=2, swin_embed=12).forward
    step = make_train_step(forward=fwd, policy=policy)
    params, state = _weights()
    p0 = dict(W.leaves(params))
    p0 = {k: v.clone() for k, v in p0.items()}
    opt = adam_init(params)
    losses, grad = [], None
    for i, x in enumerate(batches):
        params, state, opt, loss = step(params, state, opt, x, LR)
        losses.append(float(loss))
        if i == 0:
            grad = {k: float((m / 0.1).norm()) for k, m in
                    W.leaves(opt["mu"])}
    change = {k: float((v - p0[k]).norm()) for k, v in W.leaves(params)}
    return {"loss": losses, "grad": grad, "change": change}


def _readings(first, ref):
    from benchmark.drivers.train_family import readings
    p0 = {k: v.clone() for k, v in W.leaves(_weights()[0])}
    return readings(first, ref, p0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_follows_the_reference(precision):
    params, state = _weights()
    x = frames.make_pool(SEED, 2, [64, 64], device=torch.device("cpu"))
    out, _ = swin_onet_forward(params, state, x, policy=POLICIES[precision])
    lt, ld, vt, vd = R.twin(params["top"], x, window=2)
    ref_loss = float(R.jsd_loss(lt, ld, vt, vd))
    s = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
    scale = float(torch.maximum(vt.abs().max(), vd.abs().max()))
    gap_v = max(float((out.Vt - vt).abs().max()),
                float((out.Vd - vd).abs().max())) / scale
    gap_s = float((out.S - s).abs().max())
    gap_loss = abs(float(compute_loss(out)) - ref_loss) / abs(ref_loss)
    if precision == "fp32":
        assert gap_v < 1e-5 and gap_s < 1e-5 and gap_loss < 1e-6
    else:
        assert gap_v < BF16_V and gap_s < BF16_V and gap_loss < BF16_LOSS


def test_every_gradient_follows_the_reference_in_float32(batches):
    params, state = _weights()
    fwd = get_arch("swin", swin_window=2, swin_embed=12).forward
    step = make_train_step(forward=fwd, policy=DEFAULT)
    loss, _, grads = step.loss_and_grads(params, state, batches[0])
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in W.leaves(params)}
    ref_loss = R.loss_of(W.rebuild(params, p)["top"], batches[0], window=2)
    names = list(p)
    ref = torch.autograd.grad(ref_loss, [p[k] for k in names])
    got = dict(W.leaves(grads))
    ref_value = float(ref_loss.detach())
    assert abs(float(loss) - ref_value) < 1e-6 * abs(ref_value)
    scale = float(np.median([float(g.abs().max()) for g in ref]))
    for k, g in zip(names, ref):
        gap = float((got[k] - g).abs().max())
        assert gap <= 1e-5 * max(float(g.abs().max()), scale), k


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_three_adam_steps_follow_the_reference(precision, batches,
                                               reference):
    got = _readings(_program_first(batches, POLICIES[precision]), reference)
    lim = FP32_TRAIN if precision == "fp32" else BF16_TRAIN
    assert all(got[k] < lim[k] for k in lim), got


@pytest.mark.parametrize("fault", ["no_mask", "no_rpb"])
def test_the_reference_without_a_part_fails_the_tolerances(fault, batches,
                                                          reference):
    params, _ = _weights()
    x = batches[0][:2]
    _, _, vt, vd = R.twin(params["top"], x, window=2)
    _, _, vt2, vd2 = R.twin(params["top"], x, window=2, fault=(fault,))
    scale = float(vt.abs().max())
    assert float((vt2 - vt).abs().max()) / scale > 1e-5
    stand_in = R.train_steps(params, batches, LR, window=2, fault=(fault,))
    from benchmark.drivers.train_family import reference_first
    p0 = {k: v.clone() for k, v in W.leaves(params)}
    got = _readings(reference_first(stand_in, p0), reference)
    assert any(got[k] > FP32_TRAIN[k] for k in FP32_TRAIN), got
    assert any(got[k] > BF16_TRAIN[k] for k in BF16_TRAIN), got


@pytest.fixture(scope="module")
def published_forward():
    """One forward at 224^2, window 7, embed 96, batch 1 (two images
    through the twin): its spans, counters and operations."""
    from torch.utils.flop_counter import FlopCounterMode
    params, state = _weights(PUBLISHED)
    x = frames.make_pool(SEED, 1, [224, 224], device=torch.device("cpu"))
    before, mark = profiling.counters(), profiling.mark()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        swin_onet_forward(params, state, x)
    after = profiling.counters()
    return {"spans": collections.Counter(r.name for r in
                                         profiling.spans(since=mark)),
            "counters": {k: after[k] - before.get(k, 0)
                         for k in ("swin.windows", "swin.shifted_windows")},
            "flops": {str(k): v for k, v in
                      fc.get_flop_counts()["Global"].items()},
            "total": fc.get_total_flops()}


def test_spans_and_counters_of_one_published_forward(published_forward):
    assert published_forward["spans"]["swin.window_attention"] == 14
    assert published_forward["spans"]["layer_norm"] == 37
    # 338 windows an image, 168 of them shifted; the twin runs 2 images
    assert published_forward["counters"] == {"swin.windows": 2 * 338,
                                             "swin.shifted_windows": 2 * 168}


def test_work_count_equals_the_flop_counter(published_forward):
    assert SW.forward_ops_per_frame(PUBLISHED) == 25_575_911_424
    assert published_forward["total"] == 25_575_911_424
    by_kind = collections.Counter()
    for w in SW.product_work(PUBLISHED, 1, train=False):
        by_kind[w["kind"]] += w["ops"]
    assert by_kind["dense"] == published_forward["flops"]["aten.mm"]
    assert (by_kind["logits"] + by_kind["values"]
            == published_forward["flops"]["aten.bmm"])
    assert by_kind["conv"] == published_forward["flops"]["aten.convolution"]
    assert [round(by_kind[k] / 1e9, 2) for k in ("dense", "conv")] == [
        24.59, 0.13]
    assert round((by_kind["logits"] + by_kind["values"]) / 1e9, 2) == 0.86
    # training: forward, both gradients of each product, the convs'
    # weight gradients only
    train = SW.product_work(PUBLISHED, 1, train=True)
    assert sum(w["ops"] for w in train) == 3 * 25_575_911_424 - (
        by_kind["conv"])
