"""Runs of the benchmark at a tiny size on the CPU, past its look for a
card: sound runs come out correct; with the timed path broken underneath,
or with the control in the program's place, ``correct`` comes out false
under the cells' own limits."""

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import tiny


def _flip_patch(labels):
    out = labels.clone()
    out[:, :8, :8] = 1 - out[:, :8, :8]
    return out


def _half_batch(s, labels):
    """Only the first half of the batch served; its masks stand in for
    the rest."""
    n = labels.shape[0] // 2
    return s, torch.cat([labels[:n], labels[:labels.shape[0] - n]])


def test_sound_train_run_is_correct():
    r = tiny.run(tiny.TRAIN, precision="fp32")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_frames_per_s", "setup_s"}


@pytest.mark.parametrize("cell,metric", [
    (tiny.SERVE_BF16, "serve_frames_per_s"),
    (tiny.SERVE_INT8, "serve_frames_per_s.int8"),
    (tiny.REQUESTS, "request_p95_ms")])
def test_sound_serving_run_is_correct(cell, metric):
    over = {} if cell == tiny.SERVE_INT8 else {"precision": "fp32"}
    r = tiny.run(cell, **over)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {metric, "setup_s"}
    assert list(r)[-1] == "checks"


def test_train_state_left_unchanged_is_caught(monkeypatch):
    import onet_tpu_torch.train.steps as S

    def frozen(grads, opt_state, lr):
        return S.tree_map(torch.zeros_like, grads), opt_state

    monkeypatch.setattr(S, "adam_update", frozen)
    r = tiny.run(tiny.TRAIN, precision="fp32")
    assert not r["correct"]
    assert r["checks"]["change"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_caught(monkeypatch):
    import onet_tpu_torch.train.steps as S
    from onet_tpu_torch.models.onet import OnetOutput, compute_loss

    def half(out):
        n = out.S.shape[0] // 2
        return compute_loss(OnetOutput(*(None if t is None else t[:n]
                                         for t in out)))

    monkeypatch.setitem(S.LOSSES, "jsd", half)
    r = tiny.run(tiny.TRAIN, precision="fp32")
    assert not r["correct"], r["checks"]


def test_train_leaf_moved_double_is_caught(monkeypatch):
    import onet_tpu_torch.train.steps as S
    real = S.adam_update

    def double_one(grads, opt_state, lr):
        upd, st = real(grads, opt_state, lr)
        upd["top"]["down2"]["conv1"]["w"] = 2 * upd["top"]["down2"]["conv1"]["w"]
        return upd, st

    monkeypatch.setattr(S, "adam_update", double_one)
    r = tiny.run(tiny.TRAIN, precision="fp32")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("from_window_step", [1, 2])
def test_train_fault_after_set_up_is_caught(monkeypatch, from_window_step):
    """A step that goes wrong only once set-up has warmed it (a graph
    replayed, a kernel switched, optimizer state gone stale): the steps
    compared are the window's own."""
    import onet_tpu_torch.train.steps as S
    from benchmark.drivers import train
    real = S.adam_update
    calls = [0]

    def stale_later(grads, opt_state, lr):
        calls[0] += 1
        upd, st = real(grads, opt_state, lr)
        if calls[0] >= train.WARM_STEPS + from_window_step:
            upd = S.tree_map(torch.zeros_like, upd)
        return upd, st

    monkeypatch.setattr(S, "adam_update", stale_later)
    r = tiny.run(tiny.TRAIN, precision="fp32")
    assert calls[0] > train.WARM_STEPS + train.CHECKED_STEPS - 1
    assert not r["correct"], r["checks"]


def _break_serving(monkeypatch, cell, fault):
    import onet_tpu_torch.models.infer as I
    import onet_tpu_torch.models.quant as Q
    mod, name = ((Q, "onet_infer_q") if cell == tiny.SERVE_INT8
                 else (I, "onet_infer"))
    real = getattr(mod, name)

    def broken(*a, **k):
        s, labels = real(*a, **k)
        if fault == "answer":
            return s, _flip_patch(labels)
        return _half_batch(s, labels)

    monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
@pytest.mark.parametrize("cell", [tiny.SERVE_BF16, tiny.SERVE_INT8,
                                  tiny.REQUESTS])
def test_broken_serving_is_caught(monkeypatch, cell, fault):
    _break_serving(monkeypatch, cell, fault)
    over = {} if cell == tiny.SERVE_INT8 else {"precision": "fp32"}
    r = tiny.run(cell, **over)
    assert not r["correct"], r["checks"]


def test_train_control_is_not_correct():
    ctx = tiny.context(tiny.TRAIN)
    got = calibrate.train_side(harness, ctx, "control")
    assert not harness.judge(got), got


@pytest.mark.parametrize("cell", [tiny.SERVE_BF16, tiny.REQUESTS])
def test_bf16_serving_control_is_not_correct(cell):
    ctx = tiny.context(cell)
    got = calibrate.fp8_control(harness, ctx)
    assert not harness.judge(got), got


def test_int8_serving_control_is_not_correct():
    ctx = tiny.context(tiny.SERVE_INT8)
    got = calibrate.int8_control(harness, ctx)
    assert not harness.judge(got), got


def test_judge():
    assert harness.judge({"a": (0.1, 0.2), "b": (5.0, None)})
    assert not harness.judge({"a": (0.3, 0.2)})
    assert not harness.judge({"a": (float("nan"), 0.2)})
    assert np.isfinite(harness.judge({}))
