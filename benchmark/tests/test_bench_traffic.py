"""The traffic repeats under a seed, and every seed offers the same work."""

import numpy as np
import torch

from benchmark.traffic import arrivals, frames

CPU = torch.device("cpu")


def test_frames_repeat_under_a_seed():
    a = frames.make_pool(2 ** 40 + 3, 5, [32, 48], device=CPU, chunk=2)
    b = frames.make_pool(2 ** 40 + 3, 5, [32, 48], device=CPU, chunk=2)
    c = frames.make_pool(2 ** 40 + 4, 5, [32, 48], device=CPU, chunk=2)
    assert a.shape == (5, 32, 48, 1) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    lo = a.amin(dim=(1, 2, 3))
    hi = a.amax(dim=(1, 2, 3))
    assert torch.all(lo == 0) and torch.all((hi - 1).abs() < 1e-6)


def test_psnr_levels_are_one_set_in_another_order():
    a = frames.psnr_levels(12, 0.0, 10.0, 1)
    b = frames.psnr_levels(12, 0.0, 10.0, 2)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.sort(b))
    assert a.min() > 0 and a.max() < 10


def test_arrivals_repeat_and_share_their_gaps():
    a = arrivals.schedule("exp_quantile_gaps", 20.0, 10.0, 7)
    b = arrivals.schedule("exp_quantile_gaps", 20.0, 10.0, 7)
    c = arrivals.schedule("exp_quantile_gaps", 20.0, 10.0, 8)
    np.testing.assert_array_equal(a, b)
    assert len(a) == 200 and a[0] == 0 and np.all(np.diff(a) > 0)
    assert a[-1] < 10.0
    ga = np.sort(np.diff(np.append(a, 10.0)))
    gc = np.sort(np.diff(np.append(c, 10.0)))
    assert not np.array_equal(a, c)
    # the same gaps (the one the order puts first closes the window)
    np.testing.assert_allclose(ga, gc, rtol=1e-9, atol=1e-12)
