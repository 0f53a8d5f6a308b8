"""The command line's multi-device flags (``onet_tpu_torch/run.py`` and
``parallel/launch.py``) on the CPU, each against the one-process command
from the same seed and data.

* ``simclutter --dp 2``: the command as a user runs it, its two ranks
  spawned by the launcher (gloo on the CPU); the loss and eval lines of
  its log against the one-process command's.
* ``--sp 2``, ``--sp 1x2``, ``--pp 2`` and ``zy3 --dp 2``: each rank of
  one module-scoped world of 2 processes (tests/torch_parallel_worker.py)
  runs ``run.main`` as a spawned rank does; the driver's history comes
  back. ``--pp 2``'s one-process counterpart accumulates 2 microbatches
  (the pipeline computes that step; the command line has no flag for it).
* ``torchrun``: its environment makes the command join a world of one.
* a spawned rank that refuses or raises ends the command.
* ``serve --dp 2``: one process over two shards, a ragged batch, with and
  without ``--far-budget``, masks equal to ``serve``'s.

Setup: base 8, 32x32 frames from numpy (reference-schema .pt files), 2
epochs of batch 4. Tolerances, as tests/test_torch_parallel_drivers.py:
the loss history within 1e-4 relative, eval metrics within 1e-2.
"""

import functools
import os
import re
import socket

import numpy as np
import pytest
import torch

from onet_tpu_torch import run as TR
from onet_tpu_torch.core.checkpoint import save_checkpoint
from onet_tpu_torch.core.prng import make_generator
from onet_tpu_torch.models.onet import onet_init

from torch_parallel_worker import World

CPU = ["--device", "cpu"]
HW = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_figures(monkeypatch):
    from onet_tpu_torch import report
    from onet_tpu_torch.train import simclutter, zy3
    for mod in (report, simclutter, zy3):
        monkeypatch.setattr(mod, "can_draw", lambda: False)


def _yaml(section, **over):
    import yaml

    from onet_tpu_torch.core.config import DEFAULT_CONFIG
    with open(DEFAULT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg[section].update(over)
    path = f"{over['out_root']}_{section}.yml"
    with open(path, "w") as f:
        f.write(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A simclutter .pt (16 frames), ZY-3 .pt files (8 train, 3 test), a
    base-8 checkpoint and 5 frames to serve."""
    from onet_tpu_torch.data.export import export_zy3_pt
    from onet_tpu_torch.data.zy3 import synthesize_zy3

    root = tmp_path_factory.mktemp("cli_par")
    out = {"root": str(root)}
    rng = np.random.default_rng(6)
    out["sim"] = str(root / "frames.pt")
    torch.save({"rayleigh_imgs": torch.from_numpy(rng.uniform(
        0, 1, (16, 1, HW, HW)).astype(np.float32)),
        "rayleigh_labels": torch.from_numpy(
            (rng.uniform(0, 1, (16, HW, HW)) > 0.9).astype(np.float32)),
        "psnr": [0, 1, 2, 5] * 4}, out["sim"])
    for key, seed, n in (("zy3_train", 10, 8), ("zy3_test", 11, 3)):
        ds, _ = synthesize_zy3(make_generator(seed, "cpu"), n=n, size=HW,
                               device="cpu")
        out[key] = str(root / f"{key}.pt")
        export_zy3_pt(out[key], ds, [f"17000000{seed}{i}" for i in range(n)])
    p, s = onet_init(torch.Generator().manual_seed(5), 1, base=8,
                     device="cpu")
    out["ck"] = str(root / "ck_epoch_3.npz")
    save_checkpoint(out["ck"], p, s, 3)
    out["frames"] = str(root / "serve.npz")
    np.savez(out["frames"], imgs=np.random.default_rng(0).uniform(
        0, 1, (5, HW, HW, 1)).astype(np.float32))
    return out


def _sim_argv(files, out_root, *flags):
    yml = _yaml("Rayleigh", input_sz=HW, epoch_nums=2,
                batch_sz=4, out_root=out_root,
                dataset_root=os.path.join(files["root"], "none"))
    return (["simclutter", "--config", yml, "--base-channels", "8",
             "--data-file", files["sim"]] + list(flags) + CPU)


def _zy3_argv(files, out_root, *flags):
    yml = _yaml("zy3", epoch_nums=2, batch_sz=4,
                out_root=out_root,
                dataset_root=os.path.join(files["root"], "none"))
    return (["zy3", "--config", yml, "--base-channels", "8", "--train-file",
             files["zy3_train"], "--test-file", files["zy3_test"]]
            + list(flags) + CPU)


def _caught(monkeypatch, driver):
    """The driver's history of the next command in this process."""
    import importlib
    mod = importlib.import_module(f"onet_tpu_torch.train.{driver}")
    real, caught = mod.train, []

    def train(*a, **k):
        out = real(*a, **k)
        caught.append(out[2])
        return out

    monkeypatch.setattr(mod, "train", train)
    return caught


def _same_history(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert list(got["eval"]) == list(want["eval"])
    for e, m in want["eval"].items():
        for k, v in m.items():
            assert abs(float(got["eval"][e][k]) - float(v)) <= 1e-2, (e, k)


def _log_lines(out_root):
    """The epoch lines of the driver's log: (loss, {metric: value})."""
    (log,) = [f for f in os.listdir(out_root) if f.endswith(".log")]
    rows = []
    with open(os.path.join(out_root, log)) as f:
        for line in f:
            if "===Epoch:" not in line:
                continue
            loss = float(re.search(r"loss: ([0-9.]+)", line).group(1))
            mets = dict((k, float(v)) for k, v in re.findall(
                r"(acc|miou|dr|far):([0-9.E+-]+)", line))
            rows.append((loss, mets))
    return rows


def test_dp_command_spawns_ranks(files, tmp_path):
    """``simclutter --dp 2 --device cpu``: two spawned ranks (gloo), one
    log and one set of checkpoints from rank 0, its epoch lines against
    the one-process command's."""
    one, dp = str(tmp_path / "one"), str(tmp_path / "dp")
    TR.main(_sim_argv(files, one))
    TR.main(_sim_argv(files, dp, "--dp", "2"))
    want, got = _log_lines(one), _log_lines(dp)
    assert len(got) == len(want) == 2
    for (lg, mg), (lw, mw) in zip(got, want):
        assert abs(lg - lw) <= 1e-4 * lw
        assert mg.keys() == mw.keys() and all(
            abs(mg[k] - mw[k]) <= 1e-2 for k in mw)
    def written(root):        # figures: drawn by the spawned rank 0 only
        return sorted(f for f in os.listdir(root) if not f.endswith(".png"))

    assert written(dp) == written(one)


@pytest.mark.parametrize("kind,want", [
    ("refusal", r"\Abatch 5 must divide --dp 2\Z"),
    ("error", r"\Arank 1 failed:\nTraceback .*ValueError: rank 1 broke")],
    ids=["refusal", "error"])
def test_a_failing_rank_ends_the_command(kind, want):
    """A spawned rank that refuses ends the command with its message (as
    the one-process command would exit), one that raises with its
    traceback; the rank still waiting is stopped."""
    import multiprocessing as mp

    from onet_tpu_torch.parallel import launch
    from torch_parallel_worker import failing_rank

    with pytest.raises(SystemExit) as got:
        launch.launch(2, "cpu", failing_rank, kind)
    assert re.search(want, str(got.value), re.S), str(got.value)
    assert not mp.active_children()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("cli_world")))
    yield w
    w.close()


CASES = {"sp2": ("simclutter", ["--sp", "2"]),
         "sp1x2": ("simclutter", ["--sp", "1x2"]),
         "pp2": ("simclutter", ["--pp", "2"]),
         "zy3_dp2": ("zy3", ["--dp", "2"])}


@pytest.mark.parametrize("case", list(CASES))
def test_flags_in_world_match_one_process(world, files, tmp_path,
                                          monkeypatch, case):
    """Each flag's ranks in a world of 2 against the one-process command
    (``--pp 2``: with the driver's train step accumulating 2
    microbatches, the step the pipeline computes)."""
    driver, flags = CASES[case]
    argv = _sim_argv if driver == "simclutter" else _zy3_argv
    out = world.run("cli", argv=argv(files, str(tmp_path / "mesh"), *flags),
                    driver=driver)
    caught = _caught(monkeypatch, driver)
    if case == "pp2":
        from onet_tpu_torch.train import simclutter as S
        monkeypatch.setattr(S, "make_train_step", functools.partial(
            S.make_train_step, microbatches=2))
    TR.main(argv(files, str(tmp_path / "one")))
    _same_history(out[0]["hist"], caught[0])
    np.testing.assert_array_equal(out[0]["hist"]["loss"],
                                  out[1]["hist"]["loss"])


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_torchrun_environment(files, tmp_path, monkeypatch):
    """Under torchrun's environment the command joins that world (here of
    one process) and runs its rank: the history equals the one-process
    command's bit for bit (one rank's sums are its own); a world of
    another size than the flags need is refused."""
    caught = _caught(monkeypatch, "simclutter")
    TR.main(_sim_argv(files, str(tmp_path / "one")))
    for k, v in (("WORLD_SIZE", "1"), ("RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    TR.main(_sim_argv(files, str(tmp_path / "run"), "--dp", "1"))
    assert caught[1]["loss"] == caught[0]["loss"]
    assert caught[1]["eval"] == caught[0]["eval"]
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(SystemExit, match="needs 2 processes, one a device; "
                                         "torchrun started 1"):
        TR.main(_sim_argv(files, str(tmp_path / "two"), "--dp", "2"))


@pytest.mark.parametrize("flags", [[], ["--far-budget", "0.05"]],
                         ids=["argmax", "detector"])
def test_serve_dp_matches_serve(files, tmp_path, flags):
    """``serve --dp 2 --serve-batch 3`` on 5 frames: the serving loop pads
    the last batch of 2 to 3, the shards pad each batch of 3 to 4 (the
    last frame repeated) and cut it back, so every forward takes 2 frames;
    masks equal to ``serve --serve-batch 2``'s, whose forwards take 2
    frames too (the CPU's bf16 conv rounds apart at other batch sizes, and
    a pixel at a tie can flip). The detector's threshold, calibrated by
    the first run on its first batch, is handed to the second in its
    sidecar."""
    import shutil
    outs = {}
    for tag, extra in (("one", ["--serve-batch", "2"]),
                       ("dp", ["--serve-batch", "3", "--dp", "2"])):
        ck = str(tmp_path / f"{tag}.npz")
        shutil.copy(files["ck"], ck)
        if tag == "dp" and flags:
            shutil.copy(str(tmp_path / "one.npz.detector.json"),
                        ck + ".detector.json")
        outs[tag] = str(tmp_path / f"{tag}_masks.npz")
        TR.main(["serve", "--model", ck, "--input", files["frames"],
                 "--out", outs[tag]] + flags + extra + CPU)
    with np.load(outs["one"]) as a, np.load(outs["dp"]) as b:
        assert a["masks"].shape == (5, HW, HW)
        np.testing.assert_array_equal(b["masks"], a["masks"])


def test_serve_shards_pad_and_gather():
    """The shard step itself: a ragged batch of 3 over 2 shards runs the
    shards on 2 frames each (the last frame repeated) and returns 3."""
    seen = []

    def step(m, xb):
        seen.append(xb.shape[0])
        return xb * m, (xb > 0.5).to(torch.int32)

    x = torch.rand(3, 4, 4, 1)
    s, labels = TR._serve_shards(step, 2.0, [torch.device("cpu")] * 2)(
        None, x)
    assert seen == [2, 2]
    assert torch.equal(s, x * 2.0) and labels.shape == (3, 4, 4, 1)


@pytest.mark.parametrize("argv,msg", [
    (["simclutter", "--dp", "2"], "--dp 2 but only 1 devices visible"),
    (["simclutter", "--sp", "2"],
     "--sp 2 with --dp 1 needs 2 devices, only 1 visible"),
    (["simclutter", "--pp", "2"],
     "--pp with --dp 1 needs 2 devices, only 1 visible"),
    (["zy3", "--dp", "2"], "--dp 2 but only 1 devices visible"),
    (["serve", "--model", "m.npz", "--dp", "2"], "--dp 2: only 1 devices"),
])
def test_flags_need_a_card_per_rank(monkeypatch, argv, msg):
    """On a one-card host a need of 2 exits with JAX's message before any
    rank starts (the spawner is never reached)."""
    from onet_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(launch, "run_world", lambda *a, **k: pytest.fail(
        "a rank was started"))
    with pytest.raises(SystemExit) as e:
        TR.main(argv + ["--device", "cuda"])
    assert str(e.value) == msg
