"""Guards of the port's boundaries: it imports neither JAX nor the JAX
package, and its entry points run on the card or raise, never falling
back to the CPU on their own."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import onet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_onet_tpu():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        onet_tpu_torch.__path__, "onet_tpu_torch."))
    assert "onet_tpu_torch.ops.conv_wp" in mods
    assert "onet_tpu_torch.serve.http" in mods
    assert "onet_tpu_torch.train.steps" in mods
    assert "onet_tpu_torch.metrics.segmentation" in mods
    assert "onet_tpu_torch.ops.head" in mods
    assert "onet_tpu_torch.ops.conv_bd" in mods
    assert "onet_tpu_torch.runs.bd_epilogue_probe" in mods
    assert "onet_tpu_torch.runs.bd_probe" in mods
    for new in ("core.prng", "core.checkpoint", "sim.targets",
                "sim.rayleigh", "sim.kdist", "data.arrays",
                "data.simclutter", "data.augment", "models.arch",
                "report.logs", "report.curves", "train.preempt",
                "train.simclutter", "metrics.roc", "metrics.cfar",
                "data.zy3", "data.nau", "train.two_stage", "train.nau",
                "train.sweeps", "models.onet", "utils.summary",
                "preprocess.haze", "preprocess.image",
                "preprocess.curation", "preprocess.onramp", "report.xlsx",
                "report.tables", "train.zy3", "serve.tiles",
                "serve.artifact", "data.export", "data.tilestore",
                "data.verify", "models.quant", "models.qtrain",
                "ops.conv_i8", "runs.quant_validate", "models.swin",
                "models.convnext", "models.transunet", "models.iic",
                "models.infoseg", "train.iic", "train.infoseg",
                "train.baseline"):
        assert "onet_tpu_torch." + new in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'onet_tpu' or "
            "m.startswith('onet_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from onet_tpu_torch.core.bridge import (
        adam_state_from_jax, from_jax_numpy, import_torch_state,
        load_onet_npz)
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.core.checkpoint import load_onet_auto
    from onet_tpu_torch.core.prng import RngStream, make_generator
    from onet_tpu_torch.data.simclutter import (load_simclutter_pt,
                                                simclutter_datasets)
    from onet_tpu_torch.serve.http import ServingSession
    from onet_tpu_torch.sim.kdist import KDistSimulator, kdist_frames
    from onet_tpu_torch.sim.rayleigh import (generate_rayleigh_dataset,
                                             rayleigh_frames)
    from onet_tpu_torch.train.simclutter import SimclutterConfig, train
    from onet_tpu_torch.data.nau import load_nau_dict_pt, synthesize_nau_rain
    from onet_tpu_torch.train.sweeps import (per_snr_datasets, train_by_snr,
                                             verify_checkpoint_dir)
    from onet_tpu_torch.data.zy3 import (load_zy3_dict_pt,
                                         synthesize_cloud_addition,
                                         synthesize_zy3)
    from onet_tpu_torch.preprocess.onramp import (choose_preprocess,
                                                  load_image_u8,
                                                  prepare_zy3_thumbnails)
    from onet_tpu_torch.train import zy3 as Z
    from onet_tpu_torch.serve.artifact import (export_fn_artifact,
                                               export_serving_artifact,
                                               load_serving_artifact)
    from onet_tpu_torch.serve.tiles import infer_tiled
    from onet_tpu_torch.data.tilestore import load_store
    from onet_tpu_torch.data.verify import verify_dataset
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.models.iic import iic_init
    from onet_tpu_torch.models.infoseg import infoseg_init
    from onet_tpu_torch.train import iic as TI, infoseg as TF

    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda:0"),
        lambda: onet_init(gen, 1, base=8),
        lambda: from_jax_numpy({"w": np.zeros(2, np.float32)}, {}),
        lambda: import_torch_state({}),
        lambda: load_onet_npz(str(tmp_path / "missing.npz")),
        lambda: adam_state_from_jax(0, {"w": np.zeros(2, np.float32)},
                                    {"w": np.zeros(2, np.float32)}),
        lambda: ServingSession(None, None, batch=1, in_channels=1),
        lambda: RngStream(0),
        lambda: RngStream(0, "cpu").next("cuda"),
        lambda: make_generator(0),
        lambda: rayleigh_frames(gen, 0.0, n_frames=1, frame_size=8, crop=8),
        lambda: generate_rayleigh_dataset(gen, levels=(0,),
                                          frames_per_level=1, crop=8),
        lambda: KDistSimulator(gen, size=8),
        lambda: kdist_frames(gen, 0.0, n_frames=1, size=8, crop=8),
        lambda: simclutter_datasets(gen, frames_per_level=1, crop=8),
        lambda: load_simclutter_pt(str(tmp_path / "missing.pt")),
        lambda: load_onet_auto(str(tmp_path / "missing.npz")),
        lambda: train(SimclutterConfig(base_channels=8, input_sz=8,
                                       frames_per_level=1, epoch_nums=1,
                                       out_root=str(tmp_path)), log=False),
        lambda: load_nau_dict_pt(str(tmp_path / "missing.pt")),
        lambda: synthesize_nau_rain(gen, n=1, size=8),
        lambda: per_snr_datasets(0, levels=(0,), frames_per_level=1, crop=8),
        lambda: train_by_snr(SimclutterConfig(base_channels=8, input_sz=8,
                                              frames_per_level=1,
                                              epoch_nums=1,
                                              out_root=str(tmp_path)),
                             levels=(0,)),
        lambda: verify_checkpoint_dir(str(tmp_path)),
        lambda: load_zy3_dict_pt(str(tmp_path / "missing.pt")),
        lambda: synthesize_zy3(gen, n=1, size=8),
        lambda: synthesize_cloud_addition(gen, n=1, size=8),
        lambda: Z.train(Z.Zy3Config(base_channels=8, input_sz=8,
                                    epoch_nums=1, out_root=str(tmp_path)),
                        None, None, log=False),
        lambda: load_image_u8(str(tmp_path / "missing.png")),
        lambda: prepare_zy3_thumbnails([str(tmp_path / "missing.png")]),
        lambda: choose_preprocess(None, None, [], []),
        lambda: load_serving_artifact(str(tmp_path / "missing.onetp")),
        lambda: export_serving_artifact({}, {}, str(tmp_path / "a"),
                                        input_hw=(8, 8)),
        lambda: export_fn_artifact(None, str(tmp_path / "a"),
                                   input_hw=(8, 8), in_channels=1),
        lambda: infer_tiled(None, None, np.zeros((8, 8, 1), np.float32)),
        lambda: load_store(str(tmp_path / "missing.ts")),
        lambda: verify_dataset(str(tmp_path / "missing.pt")),
        lambda: get_arch("swin", swin_window=2, swin_embed=12).init(gen, 1),
        lambda: get_arch("convnext", convnext_embed=16).init(gen, 1),
        lambda: get_arch("transunet", transunet_embed=48,
                         transunet_depth=1).init(gen, 1),
        lambda: iic_init(gen, 1, base=8),
        lambda: infoseg_init(gen, 1, base=8),
        lambda: TI.train(TI.IICConfig(base_channels=8, input_sz=8,
                                      frames_per_level=1, epoch_nums=1,
                                      out_root=str(tmp_path)), log=False),
        lambda: TF.train(TF.InfoSegConfig(base_channels=8, input_sz=8,
                                          frames_per_level=1, epoch_nums=1,
                                          out_root=str(tmp_path)),
                         log=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_onet_init_is_seeded_and_full_width():
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import param_count, tree_leaves

    p1, s1 = onet_init(torch.Generator().manual_seed(3), 1, device="cpu")
    p2, _ = onet_init(torch.Generator().manual_seed(3), 1, device="cpu")
    assert param_count(p1) == 31_036_416       # the JAX package's count
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert p1["top"]["inc"]["conv1"]["w"].shape == (3, 3, 1, 64)
    assert s1["top"]["up4"]["conv"]["bn2"]["var"].shape == (64,)
    twin, _ = onet_init(torch.Generator().manual_seed(3), 1, base=8,
                        weight_share=False, device="cpu")
    assert set(twin) == {"top", "down"}
    assert not torch.equal(twin["top"]["inc"]["conv1"]["w"],
                           twin["down"]["inc"]["conv1"]["w"])


def test_tree_helpers_walk_lists_and_empty_branches(tmp_path):
    """The parameter trees of the stateless families hold lists of block
    dicts and an empty state per branch: the tree helpers, the
    checkpoint's flattening and Adam walk them in the JAX package's order
    (dict keys sorted, list elements by index) and round-trip them."""
    from onet_tpu_torch.core.checkpoint import (_flatten, _unflatten,
                                                load_checkpoint,
                                                save_checkpoint)
    from onet_tpu_torch.models.unet import tree_leaves, tree_map, \
        tree_unflatten
    from onet_tpu_torch.train.optim import adam_init, adam_update, \
        freeze_params

    t = lambda *v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    params = {"top": {"b": [{"w": t(1.0), "g": t(2.0)}, {"w": t(3.0)}],
                      "a": t(4.0, 5.0), "enc": [t(6.0)] * 11}}
    state = {"top": {}}
    leaves = tree_leaves(params)
    assert [float(x[0]) for x in leaves] == [4, 2, 1, 3] + [6] * 11
    back = tree_unflatten(params, [x * 2 for x in leaves])
    assert isinstance(back["top"]["b"], list) and \
        float(back["top"]["b"][1]["w"]) == 6.0
    doubled = tree_map(lambda a, b: a + b, params, params)
    assert float(doubled["top"]["enc"][10]) == 12.0
    flat = _flatten(params, "p:")
    assert sorted(flat)[:4] == ["p:top/a", "p:top/b/0/g", "p:top/b/0/w",
                                "p:top/b/1/w"]
    assert "p:top/enc/10" in flat
    again = _unflatten(params, flat, "p:")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(again), leaves))
    assert _flatten(state, "s:") == {} and \
        _unflatten(state, {}, "s:") == {"top": {}}
    opt = adam_init(params)
    assert isinstance(opt["mu"]["top"]["b"], list)
    updates, opt = adam_update(tree_map(torch.ones_like, params), opt, 0.1)
    assert all(torch.allclose(u, torch.full_like(u, -0.1))
               for u in tree_leaves(updates))
    path = str(tmp_path / "list.npz")
    save_checkpoint(path, params, state, 2, opt_state=opt)
    p2, s2, e2, o2 = load_checkpoint(path, params, state, opt_template=opt)
    assert s2 == {"top": {}} and e2 == 2 and int(o2["count"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves([p2, o2["mu"], o2["nu"]]),
        tree_leaves([params, opt["mu"], opt["nu"]])))
    frozen = freeze_params(params, lambda path: path[:3] == ("top", "b",
                                                             "1"))
    assert float(frozen["top"]["b"][1]["w"]) == 0.0 and \
        float(frozen["top"]["b"][0]["w"]) == 1.0
