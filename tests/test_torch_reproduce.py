"""The port's one-command reproduction (``onet_tpu_torch/runs/
reproduce_all.py``) at the CPU-feasible ``micro`` scale, through the
command line (``run reproduce --scale micro --device cpu``): all eight
stages of the JAX package's chain run, in its order, with its scales and
anchors, and both reports are written in its schema.

Setup: base 8, 32x32 frames (the micro scale), one torch thread; no JAX
run (the JAX package's own chain test is marked slow). The checks are
structural, as the JAX package's are: stage names, anchors, scales and
the report's rows; numbers finite and in range.
"""

import json
import os

import numpy as np
import pytest
import torch

STAGES = ("gen_data", "sim_low", "sim_high", "sweep", "two_stage",
          "nau", "zy3", "choose_preprocess")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scales_and_anchors_are_the_jax_package_s():
    from runs import reproduce_all as J

    from onet_tpu_torch.runs import reproduce_all as T
    assert T.SCALES == J.SCALES and T._FULL_GEOM == J._FULL_GEOM
    assert T.ANCHORS == J.ANCHORS and tuple(T.ANCHORS) == STAGES


def test_reproduce_micro_writes_both_reports(tmp_path, monkeypatch):
    from onet_tpu_torch import report
    from onet_tpu_torch.run import main
    from onet_tpu_torch.runs.reproduce_all import SCALES
    from onet_tpu_torch.train import simclutter, zy3

    # no figures: matplotlib's first figure costs seconds here
    for mod in (report, simclutter, zy3):
        monkeypatch.setattr(mod, "can_draw", lambda: False)
    monkeypatch.chdir(tmp_path)          # datasets/ is looked up here
    out = str(tmp_path / "repro")
    main(["reproduce", "--scale", "micro", "--out", out, "--device", "cpu"])
    with open(os.path.join(out, "reproduce.json")) as f:
        rep = json.load(f)
    with open(os.path.join(out, "REPRODUCE.md")) as f:
        md = f.read()
    assert rep["scale"] == "micro" and rep["backend"] == "cpu"
    assert rep["params"] == json.loads(json.dumps(SCALES["micro"]))
    assert tuple(rep["stages"]) == STAGES
    for s in STAGES:
        assert rep["stages"][s]["seconds"] >= 0
        assert "anchor" in rep["stages"][s]
    assert rep["stages"]["gen_data"]["frames"] == 11 * 2
    for s in ("sim_low", "sim_high", "zy3"):
        e = rep["stages"][s]["final_eval"]
        assert all(0 <= e[k] <= 1 for k in ("acc", "miou", "dr", "far"))
        assert all(np.isfinite(v) for v in e.values())
    assert set(rep["stages"]["sweep"]) >= {"PSNR0-2", "PSNR5-10"}
    assert {"Onet", "CFAR", "InfoSeg", "IIC"} == set(
        rep["stages"]["nau"]["methods"])
    assert rep["stages"]["nau"]["figure"] is None
    c = rep["stages"]["choose_preprocess"]
    assert None not in (c["acc_before"], c["acc_after"], c["miou_before"])
    for s in ("nau", "zy3", "choose_preprocess"):
        assert rep["stages"][s]["comparability"] == "synthetic-data"
    for label in ("gen-data", "simclutter PSNR0-2", "simclutter PSNR5-10",
                  "per-PSNR verify", "two-stage", "NAU transfer",
                  "zy3 (1 epochs)", "preprocess selection",
                  "synthetic-data", "Stage wall times"):
        assert label in md, label
    assert os.path.exists(os.path.join(out, "zy3", "onet_zy3_reproduce.npz"))
