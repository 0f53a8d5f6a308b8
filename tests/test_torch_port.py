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
    from onet_tpu_torch.serve.http import ServingSession

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
