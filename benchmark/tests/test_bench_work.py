"""The frozen work count against a count by hand at a small shape."""

from benchmark.work.onet import (branch_sites, bound_seconds, conv_work,
                                 forward_ops_per_frame, ideal_seconds)

CFG = {"precision": "bf16", "in_channels": 1, "base": 2,
       "input_hw": [16, 16]}


def test_forward_count_by_hand():
    # widths 2-4-8-16-32 at 16, 8, 4, 2, 1; a 3x3 conv is 9 ci co h w
    # multiply-adds, a 2x2 stride-2 transposed conv ci co (2h)(2w)
    macs = (9 * 1 * 2 * 256 + 9 * 2 * 2 * 256            # inc
            + 9 * 2 * 4 * 64 + 9 * 4 * 4 * 64            # down1
            + 9 * 4 * 8 * 16 + 9 * 8 * 8 * 16            # down2
            + 9 * 8 * 16 * 4 + 9 * 16 * 16 * 4           # down3
            + 9 * 16 * 32 * 1 + 9 * 32 * 32 * 1          # down4
            + 32 * 16 * 4 + 9 * 32 * 16 * 4 + 9 * 16 * 16 * 4   # up1
            + 16 * 8 * 16 + 9 * 16 * 8 * 16 + 9 * 8 * 8 * 16    # up2
            + 8 * 4 * 64 + 9 * 8 * 4 * 64 + 9 * 4 * 4 * 64     # up3
            + 4 * 2 * 256 + 9 * 4 * 2 * 256 + 9 * 2 * 2 * 256)  # up4
    assert forward_ops_per_frame(CFG) == 2 * 2 * macs     # 2 ops, 2 branches


def test_published_width():
    cfg = dict(CFG, base=64, input_hw=[512, 512])
    per_branch = forward_ops_per_frame(cfg) / 2
    assert abs(per_branch / 1e9 - 384.70156288) < 1e-6


def test_train_counts_three_passes_but_the_first_dgrad():
    fwd = conv_work(CFG, 3, train=False)
    tr = conv_work(CFG, 3, train=True)
    assert len(tr) == 3 * len(fwd) - 1
    first = [w for w in tr if w["site"] == "inc.conv1"]
    assert [w["pass_"] for w in first] == ["fwd", "wgrad"]


def test_bytes_and_bound():
    s = branch_sites(1, 2, 16, 16)[0]          # inc.conv1, 1 -> 2
    w = conv_work(CFG, 1, train=False)[0]
    assert w["bytes"] == 2 * (2 * 256 * 1 + 9 * 1 * 2 + 2 * 256 * 2)
    assert s["co"] == 2
    peaks = {"flops_per_s": {"bf16": 1e12, "int8": 2e12}, "bytes_per_s": 1e9}
    assert bound_seconds([w], peaks) == max(w["ops"] / 1e12,
                                            w["bytes"] / 1e9)
    assert ideal_seconds([w], peaks) == w["ops"] / 1e12


def test_int8_sites_count_at_their_precision():
    cfg = dict(CFG, precision="int8",
               site_precision={"inc.conv2": "bf16", "up4.conv2": "bf16"},
               site_output={"up3.conv2": "f32"})
    work = {w["site"]: w for w in conv_work(cfg, 1, train=False)}
    assert work["inc.conv2"]["precision"] == "bf16"
    assert work["down1.conv1"]["precision"] == "int8"
    peaks = {"flops_per_s": {"bf16": 1.0, "int8": 2.0}, "bytes_per_s": 1e30}
    ideal = ideal_seconds(list(work.values()), peaks)
    ops8 = sum(w["ops"] for w in work.values() if w["precision"] == "int8")
    ops16 = sum(w["ops"] for w in work.values() if w["precision"] == "bf16")
    assert ideal == ops8 / 2.0 + ops16 / 1.0
