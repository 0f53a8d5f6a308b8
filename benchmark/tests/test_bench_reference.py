"""The plain reference against the port, at a tiny size on the CPU."""

import numpy as np
import torch

from benchmark.drivers.train import batch_order
from benchmark.inputs import onet_weights as W
from benchmark.reference import onet as R
from benchmark.reference import quant as Q
from benchmark.traffic import frames

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def _inputs(n=8, base=8, hw=32):
    p, s = W.make(SEED, 1, base, CPU)
    x = frames.make_pool(SEED, n, [hw, hw], device=CPU)
    return p, s, x


def test_train_steps_follow_the_port_in_float32():
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.steps import make_train_step
    p, s, pool = _inputs(n=16)
    order = torch.as_tensor(batch_order(SEED, 16, 4, 1))
    batches = [pool[order[i]] for i in range(3)]
    ref = R.train_steps(p, s, batches, 5e-6)
    step = make_train_step()
    pp, ss = W.make(SEED, 1, 8, CPU)
    opt = adam_init(pp)
    losses, grad = [], None
    for i, x in enumerate(batches):
        pp, ss, opt, loss = step(pp, ss, opt, x, 5e-6)
        losses.append(float(loss))
        if i == 0:
            grad = {k: float((m / 0.1).norm()) for k, m in W.leaves(opt["mu"])}
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5)
    gaps = [abs(grad[k] - ref["grad"][k]) / ref["grad"][k] for k in grad]
    # float32 on both sides; at 32^2 a rounding can switch a ReLU or a
    # pool's maximum, which moves a few small leaves by up to ~1e-2
    assert np.median(gaps) < 1e-4 and max(gaps) < 3e-2
    state = dict(W.leaves(ss))
    for k, v in ref["state"].items():
        np.testing.assert_allclose(v.numpy(), state[k].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_eval_logits_follow_the_port_in_float32():
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    p, s, x = _inputs(n=4)
    vt, vd = R.eval_logits(p, s, x)
    sm, labels = onet_infer(fold_onet(p, s), x, policy=DEFAULT)
    margin = vt - vd
    # S = softmax([vt, vd]): S_top = sigmoid(vt - vd)
    np.testing.assert_allclose(sm[..., 0].numpy(),
                               torch.sigmoid(margin).numpy(), atol=1e-5)
    got = R.label_gap(vt, vd, labels)
    assert got["label_gap"] < 1e-4 and got["flip_share"] < 1e-3


def test_int8_reference_follows_the_port():
    """With the port calibrated in float32 too, the int8 logits agree but
    for a code that rounds the other way here and there."""
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.models.quant import (calibrate, onet_infer_q,
                                             quantize_folded)
    p, s, x = _inputs(n=4)
    scales = calibrate(fold_onet(p, s), x, policy=DEFAULT)
    q = quantize_folded(fold_onet(p, s), scales)
    sm, labels = onet_infer_q(q, x)
    fp = Q.fold(p, s)
    ref_scales = Q.calibrate(fp, x)
    for site, v in scales.items():
        if site == "inc.conv1":
            continue
        c = v.shape[0]
        got = ref_scales[site]
        want = (v.reshape(2, c // 2) if site in Q.STACKED
                else v[None].expand(2, -1))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    vt, vd = Q.quant_logits(fp, ref_scales, x)
    got = R.label_gap(vt, vd, labels)
    gap, flips = got["label_gap"], got["flip_share"]
    # the port runs the two head-feature sites and the head in bf16,
    # the reference in float32: labels near a tie go either way
    assert flips < 2e-2 and gap < 0.2
    # and the int4 control is far off
    vt4, vd4 = Q.quant_logits(fp, ref_scales, x, qmax=7.0)
    got4 = R.label_gap(vt, vd, (vd4 > vt4).to(torch.uint8))
    gap4, flips4 = got4["label_gap"], got4["flip_share"]
    assert gap4 > 3 * gap and flips4 > 3 * flips
