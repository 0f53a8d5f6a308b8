"""The port's command line (``onet_tpu_torch/run.py``) on the CPU.

Held against the JAX package's command line where the two must agree
byte for byte: the parser (every subcommand's flag dests, option strings,
choices and defaults, with ``--device`` added and ``export-artifact``'s
``--platforms`` dropped), ``summary``'s stdout line for line, and
``import-torch`` / ``export-torch`` outputs key for key, bit for bit.
Every other subcommand is held against the port's library call it wraps,
run here from the same seed: checkpoints and datasets bit-equal, masks
equal, printed reports equal line for line.

Setup: base 8, 32x32 frames (the dataset generators the commands call
with full-size defaults are wrapped to 32x32 and a few frames, in the
command and in its library twin alike), one torch thread, ``--device
cpu``; no JAX training run.
"""

import argparse
import functools
import glob
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from onet_tpu import run as JR

from onet_tpu_torch import run as TR
from onet_tpu_torch.core.checkpoint import save_checkpoint
from onet_tpu_torch.core.policy import BF16_COMPUTE
from onet_tpu_torch.core.prng import make_generator
from onet_tpu_torch.models.onet import onet_init

CPU = ["--device", "cpu"]
HW = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_figures(monkeypatch):
    """The drivers and commands draw no figure here (matplotlib's first
    figure costs seconds; the figures are not what is compared)."""
    from onet_tpu_torch import report
    from onet_tpu_torch.train import simclutter, zy3
    for mod in (report, simclutter, zy3):
        monkeypatch.setattr(mod, "can_draw", lambda: False)


@pytest.fixture
def jax_init_shapes(monkeypatch):
    """JAX's ``onet_init`` replaced by zeros of its shapes
    (``jax.eval_shape``), for the commands that print shapes and counts
    or load every value from a file: JAX's eager init compiles op by op
    (~5 s a call)."""
    import jax

    from onet_tpu.models import onet as JO

    real = JO.onet_init
    monkeypatch.setattr(JO, "onet_init", lambda *a, **kw: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: real(*a, **kw))))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A base-8 checkpoint (shared and twin, 1 and 3 channels), frames."""
    root = tmp_path_factory.mktemp("cli")
    out = {"root": root}
    os.makedirs(root / "ckpts")
    for name, cin, share in (("ck", 1, True), ("tw", 1, False),
                             ("rgb", 3, True)):
        p, s = onet_init(torch.Generator().manual_seed(5), cin, base=8,
                         weight_share=share, device="cpu")
        out[name] = str(root / ("ckpts" if cin == 1 else "")
                        / f"{name}_epoch_3.npz")
        save_checkpoint(out[name], p, s, 3)
    frames = np.random.default_rng(0).uniform(
        0, 1, (5, HW, HW, 1)).astype(np.float32)
    out["frames"] = str(root / "frames.npz")
    np.savez(out["frames"], imgs=frames)
    return out


def _yaml(tmp_path, section, **over):
    """The port's YAML with ``section`` overridden (the commands read
    sizes, epochs and paths from it)."""
    import yaml

    from onet_tpu_torch.core.config import DEFAULT_CONFIG
    with open(DEFAULT_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg[section].update(over)
    path = tmp_path / f"{section}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def _subparsers(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.choices,
                            a.required)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parser_matches_jax():
    got, want = _subparsers(TR.build_parser()), _subparsers(JR.build_parser())
    assert list(got) == list(want) and len(got) == 16
    for name in want:
        assert got[name].pop("device") == (("--device",), None, None, False)
        if name == "export-artifact":
            assert want[name].pop("platforms")[1] == "tpu,cpu"
        opts, jax_cfg, *rest = want[name].pop("config")
        assert got[name].pop("config") == (
            opts, os.path.join(os.path.dirname(TR.__file__), "configs",
                               os.path.basename(jax_cfg)), *rest)
        assert got[name] == want[name], name


def test_main_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.main(["summary", "--base-channels", "8", "--input-sz", "32"])


@pytest.mark.parametrize("argv,msg,jax_too", [
    (["bench"], "benchmark", False),
    (["simclutter", "--sp", "two"], "expected ROWS or ROWSxCOLS", True),
    (["simclutter", "--sp", "2", "--pp", "2"],
     "--sp and --pp are exclusive", True),
    (["simclutter", "--dp", "3"], "batch 10 not divisible by --dp 3", True),
    (["simclutter", "--sp", "2", "--dp", "4"],
     "batch 10 not divisible by --dp 4", True),
    (["simclutter", "--pp", "3"], "batch 10 not divisible into 3 "
     "microbatches x 1 data shards (use --batch-sz)", True),
    (["simclutter", "--pp", "2", "--no-weight-share"],
     "--pp supports weight-shared models only", True),
    (["simclutter", "--pp", "2", "--int8-train", "fwd"],
     "--pp and --int8-train are exclusive", True),
    (["zy3", "--dp", "4"], "batch 5 must divide --dp 4 and the 64 train "
     "frames (use --batch-sz)", False),
])
def test_bench_and_parallel_flags_exit(argv, msg, jax_too):
    """``bench`` names the benchmark PR; the parallel flags make the JAX
    command line's refusals with its messages, before any rank starts
    (JAX's own command raises the same message where it refuses before
    any work; its zy3 refuses after synthesizing its 64 scenes)."""
    with pytest.raises(SystemExit) as got:
        TR.main(argv + CPU)
    assert msg in str(got.value)
    if jax_too:
        with pytest.raises(SystemExit) as want:
            JR.main(argv)
        assert str(got.value) == str(want.value)


def test_summary_stdout_matches_jax(capsys, jax_init_shapes):
    argv = ["summary", "--base-channels", "8", "--input-sz", str(HW)]
    JR.main(argv)
    want = _lines(capsys)
    TR.main(argv + CPU)
    assert _lines(capsys) == want
    assert want[0] == "params: 0.49 M"


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_import_export_torch_match_jax(work, tmp_path, capsys,
                                      jax_init_shapes):
    from onet_tpu_torch.core.bridge import (export_torch_checkpoint,
                                            load_onet_npz)
    for name in ("ck", "tw"):
        pt = str(tmp_path / f"{name}.pytorch")
        export_torch_checkpoint(pt, *load_onet_npz(work[name], "cpu"))
        got, want = {}, {}
        for tag, main, outs in (("jax", JR.main, want), ("port", TR.main,
                                                          got)):
            npz = str(tmp_path / f"{name}_{tag}.npz")
            main(["import-torch", "--pt", pt, "--out", npz]
                 + (CPU if tag == "port" else []))
            back = str(tmp_path / f"{name}_{tag}.pytorch")
            main(["export-torch", "--model", npz, "--out", back]
                 + (CPU if tag == "port" else []))
            outs["npz"] = _npz(npz)
            outs["pt"] = torch.load(back, weights_only=True)
            outs["log"] = [line.replace(f"_{tag}.", ".")
                           for line in _lines(capsys)]
        assert got["log"] == want["log"]
        assert list(got["npz"]) == list(want["npz"])
        for k, v in want["npz"].items():
            assert got["npz"][k].dtype == v.dtype
            assert np.array_equal(got["npz"][k], v), k
        assert got["pt"]["epoch"] == want["pt"]["epoch"]
        assert list(got["pt"]["net"]) == list(want["pt"]["net"])
        for k, v in want["pt"]["net"].items():
            g = got["pt"]["net"][k]
            assert g.dtype == v.dtype
            if k.endswith("num_batches_tracked"):
                # the reference's 0-d counter; the JAX package's file holds
                # it as [1] (np.ascontiguousarray of a 0-d array), which
                # PyTorch's load_state_dict also accepts
                assert g.shape == () and v.shape == (1,)
                v = v.reshape(())
            assert torch.equal(g, v), k


@pytest.mark.parametrize("workload,ext", [("simclutter", ".pt"),
                                          ("simclutter", ".npz"),
                                          ("zy3", ".pt"), ("nau", ".ts")])
def test_gen_data_matches_library(tmp_path, workload, ext, capsys):
    from onet_tpu_torch.data import export as E
    from onet_tpu_torch.data.nau import synthesize_nau_rain
    from onet_tpu_torch.data.tilestore import load_store
    from onet_tpu_torch.data.zy3 import synthesize_zy3
    from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset

    out = str(tmp_path / f"cli{ext}")
    TR.main(["gen-data", "--workload", workload, "--out", out, "--n", "2",
             "--levels", "3-4", "--frames-per-level", "1", "--crop",
             str(HW)] + CPU)
    gen = make_generator(1981, "cpu")
    if workload == "simclutter":
        lib = generate_rayleigh_dataset(gen, levels=(3, 4),
                                        frames_per_level=1, crop=HW,
                                        device="cpu")
        ids = None
    else:
        make = synthesize_zy3 if workload == "zy3" else synthesize_nau_rain
        lib, ids = make(gen, n=2, device="cpu")
    assert f"saved {out}" in capsys.readouterr().out
    if ext == ".pt":
        ref = str(tmp_path / "lib.pt")
        if workload == "simclutter":
            E.export_simclutter_pt(ref, lib)
        else:
            E.export_zy3_pt(ref, lib, ids)
        a, b = (torch.load(p, weights_only=False) for p in (out, ref))
        assert list(a) == list(b)
        for k in b:
            if workload == "zy3":
                assert all(torch.equal(a[k][f], b[k][f]) for f in b[k])
            elif isinstance(b[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
        return
    got = load_store(out, device="cpu") if ext == ".ts" else _npz(out)
    keys = ("imgs", "labels", "psnr") if workload == "simclutter" else \
        ("imgs", "labels")
    assert sorted(got) == sorted(keys)
    for k in keys:
        assert np.array_equal(np.asarray(got[k]), lib[k].numpy()), k


def test_verify_data_matches_library(tmp_path, capsys):
    from onet_tpu_torch.data.export import export_simclutter_pt
    from onet_tpu_torch.data.verify import format_report, verify_dataset
    from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset

    pt = str(tmp_path / "sim.pt")
    export_simclutter_pt(pt, generate_rayleigh_dataset(
        make_generator(2, "cpu"), levels=(0, 1), frames_per_level=2,
        crop=HW, device="cpu"))
    TR.main(["verify-data", pt, "--no-eval"] + CPU)
    want = format_report(verify_dataset(pt, "auto", eval_batch=False))
    assert _lines(capsys) == want.splitlines()


def _same_checkpoints(a_dir, b_dir, pattern="*.npz"):
    a = sorted(glob.glob(os.path.join(a_dir, pattern)))
    b = sorted(glob.glob(os.path.join(b_dir, pattern)))
    assert a and [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b]
    for pa, pb in zip(a, b):
        za, zb = _npz(pa), _npz(pb)
        assert list(za) == list(zb)
        assert all(np.array_equal(za[k], zb[k]) for k in zb), pa


@pytest.mark.parametrize("flags", [[], ["--no-weight-share", "--loss",
                                        "rsn"]], ids=["data_file",
                                                      "twin_rsn"])
def test_simclutter_matches_library(tmp_path, flags):
    """From a reference-schema .pt (--data-file; numpy frames and
    targets): the defaults, then --resume; the twin nets with the RSN
    loss. (The device-generated frames go through the same call; ``run
    reproduce`` drives them.)"""
    from onet_tpu_torch.data.simclutter import (load_simclutter_pt,
                                                simclutter_datasets)
    from onet_tpu_torch.train.simclutter import SimclutterConfig, train

    cli, lib = str(tmp_path / "cli"), str(tmp_path / "lib")
    yml = _yaml(tmp_path, "Rayleigh", input_sz=HW, epoch_nums=2,
                batch_sz=4, out_root=cli,
                dataset_root=str(tmp_path / "none"))
    argv = ["simclutter", "--config", yml, "--frames-per-level", "4",
            "--base-channels", "8"] + flags + CPU
    cfg = dict(model_name="onet_rayleigh" + ("_rsn" if flags else ""),
               epoch_nums=2, batch_sz=4, input_sz=HW, frames_per_level=4,
               base_channels=8, base_lr=5e-6, out_root=lib,
               weight_share=not flags, loss="rsn" if flags else "jsd")
    pt = str(tmp_path / "frames.pt")
    rng = np.random.default_rng(6)
    torch.save({"rayleigh_imgs": torch.from_numpy(rng.uniform(
        0, 1, (16, 1, HW, HW)).astype(np.float32)),
        "rayleigh_labels": torch.from_numpy(
            (rng.uniform(0, 1, (16, HW, HW)) > 0.9).astype(np.float32)),
        "psnr": [0, 1, 2, 5] * 4}, pt)
    argv += ["--data-file", pt]
    datasets = simclutter_datasets(
        make_generator(1981, "cpu"), low_snr=0, high_snr=2,
        source=load_simclutter_pt(pt, device="cpu"), device="cpu")
    TR.main(argv)
    train(SimclutterConfig(**cfg), policy=BF16_COMPUTE, datasets=datasets,
          device="cpu")
    _same_checkpoints(cli, lib)
    if flags:
        return
    # --resume continues from the newest checkpoint, as resume=True does
    TR.main(argv[:1] + ["--resume", "--epochs", "3"] + argv[1:])
    train(SimclutterConfig(**dict(cfg, epoch_nums=3), resume=True),
          policy=BF16_COMPUTE, datasets=datasets, device="cpu")
    _same_checkpoints(cli, lib, "*epoch_2_*.npz")


@pytest.fixture
def tiny_sweeps(monkeypatch):
    """per_snr_datasets at 32x32, two levels, two frames a level, drawn
    once: the command's call (seed 7, as JAX's key(7)) gets them."""
    from onet_tpu_torch.train import sweeps

    data = sweeps.per_snr_datasets(7, levels=(0, 5), frames_per_level=2,
                                   crop=HW, device="cpu")

    def tiny(seed, levels=None, frames_per_level=None, crop=None,
             device=None):
        assert seed == 7 and torch.device(device).type == "cpu"
        return data

    monkeypatch.setattr(sweeps, "per_snr_datasets", tiny)
    return data


def test_sweep_matches_library(work, tiny_sweeps, capsys):
    from onet_tpu_torch.core.checkpoint import load_arch_auto
    from onet_tpu_torch.train.sweeps import (test_by_snr,
                                             threshold_sweep_by_snr,
                                             verify_checkpoint_dir)

    TR.main(["sweep", "--model", work["ck"], "--far-budgets", "0.1"] + CPU)
    got = _lines(capsys)
    _, p, s, _ = load_arch_auto(work["ck"], "cpu")
    rep = test_by_snr(p, s, tiny_sweeps, policy=BF16_COMPUTE)
    thr = threshold_sweep_by_snr(p, s, tiny_sweeps, far_budgets=(0.1,),
                                 policy=BF16_COMPUTE)
    assert got[0] == f"[sweep] loaded {work['ck']} (arch vanilla)"
    for line, psnr in zip(got[1:3], (0, 5)):
        m = rep[psnr]
        assert line == ("psnr:%02d, acc:%.4f, miou:%.4f, tiou:%.4f, "
                        "dr:%.4f, far:%.4f" % (psnr, m["acc"], m["miou"],
                                               m["tiou"], m["dr"], m["far"]))
    assert got[3].endswith("ave_far:%.4f" % rep["ave"]["far"])
    assert got[4].startswith("psnr:00 threshold-detector | argmax dr "
                             f"{thr[0]['argmax']['dr']:.3f}")
    TR.main(["sweep", "--model-dir", os.path.dirname(work["ck"])] + CPU)
    report = verify_checkpoint_dir(os.path.dirname(work["ck"]),
                                   datasets_by_psnr=tiny_sweeps,
                                   policy=BF16_COMPUTE, device="cpu")
    lines = _lines(capsys)
    assert len(lines) == len(report) == 2
    for line, (fname, rec) in zip(lines, report.items()):
        assert line.startswith(f"{fname} (epoch 3, arch vanilla): "
                               f"ave_acc:{rec['per_snr']['ave']['acc']:.4f}")


def _library_masks(work, imgs, *, int8=False, far=None, tile=0, batch=2):
    """What ``serve`` computes, through the library directly."""
    from onet_tpu_torch.core.checkpoint import load_onet_auto
    from onet_tpu_torch.metrics.roc import quantile
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.quant import (calibrate, onet_infer_q,
                                             quantize_folded)
    from onet_tpu_torch.serve import infer_tiled

    p, s, _ = load_onet_auto(work["ck"], "cpu")
    with torch.inference_mode():
        folded = fold_onet(p, s)
        step = lambda f, x: onet_infer(f, x, policy=BF16_COMPUTE)  # noqa
        arg = folded
        if int8:
            arg = quantize_folded(folded, calibrate(
                folded, torch.from_numpy(imgs[:batch])))
            step = onet_infer_q
        if far:
            s0, _ = step(arg, torch.from_numpy(imgs[:batch]))
            score = lambda s: torch.log(s[..., 1] + 1e-9) - torch.log(  # noqa
                s[..., 0] + 1e-9)
            thr = float(quantile(score(s0).reshape(-1), 1.0 - far))
            plain = step
            step = lambda f, x: (None, (score(plain(f, x)[0])  # noqa: E731
                                        > thr).to(torch.int32))
        if tile:
            return np.stack([infer_tiled(step, arg, sc, tile=tile, halo=8,
                                         batch=batch, device="cpu")
                             for sc in imgs]).astype(np.uint8)
        pad = np.concatenate([imgs, imgs[-1:]])
        return np.concatenate([
            step(arg, torch.from_numpy(pad[i:i + batch]))[1].numpy()
            for i in range(0, len(pad), batch)])[:len(imgs)].astype(np.uint8)


@pytest.mark.parametrize("mode", ["bf16", "int8", "far_budget", "tile"])
def test_serve_matches_library(work, tmp_path, mode):
    imgs = _npz(work["frames"])["imgs"]
    argv = ["serve", "--model", work["ck"], "--input", work["frames"],
            "--serve-batch", "2", "--out", str(tmp_path / "m.npz")] + CPU
    kw = {}
    if mode == "int8":
        argv.append("--int8")
        kw["int8"] = True
    elif mode == "far_budget":
        argv += ["--far-budget", "0.05"]
        kw["far"] = 0.05
        os.makedirs(tmp_path / "m", exist_ok=True)
        ck = str(tmp_path / "m" / "ck.npz")     # its own detector sidecar
        argv[2] = ck
        import shutil
        shutil.copy(work["ck"], ck)
    elif mode == "tile":
        argv += ["--tile", "16", "--halo", "8"]
        kw["tile"] = 16
    TR.main(argv)
    got = _npz(str(tmp_path / "m.npz"))["masks"]
    assert got.shape == imgs.shape[:3]
    assert np.array_equal(got, _library_masks(work, imgs, **kw))


def test_serve_http(work, monkeypatch):
    """`serve --http 0 --http-requests 2` answers POST /segment with the
    library's masks."""
    from onet_tpu_torch.serve import http

    imgs = _npz(work["frames"])["imgs"]
    bound = threading.Event()
    real = http.start_server

    def start(sess, port):
        server = real(sess, port)
        start.url = "http://127.0.0.1:%d" % server.server_address[1]
        bound.set()
        return server

    monkeypatch.setattr(http, "start_server", start)
    th = threading.Thread(target=TR.main, args=(
        ["serve", "--model", work["ck"], "--input", work["frames"],
         "--serve-batch", "2", "--http", "0", "--http-requests", "2"]
        + CPU,), daemon=True)
    th.start()
    assert bound.wait(60)
    want = _library_masks(work, imgs)
    for _ in range(2):
        import io
        buf = io.BytesIO()
        np.save(buf, imgs)
        req = urllib.request.Request(start.url + "/segment",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert np.array_equal(np.load(io.BytesIO(r.read())), want)
    th.join(60)
    assert not th.is_alive()


def test_export_artifact_and_serve_it(work, tmp_path, monkeypatch, capsys):
    """`export-artifact` hands `export_serving_artifact` the checkpoint's
    trees, the geometry and the device (the export itself is held by
    tests/test_torch_artifact.py); `serve` of an artifact serves its call,
    here a stand-in program on the library's folded graph."""
    from onet_tpu_torch.core.checkpoint import load_onet_auto
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.unet import tree_leaves
    from onet_tpu_torch.serve import artifact

    seen = {}

    def export(params, bn, out, **kw):
        seen.update(params=params, bn=bn, out=out, **kw)
        return {"arithmetic": "bfloat16", "batch": "symbolic",
                "device": kw["device"].type}

    monkeypatch.setattr(artifact, "export_serving_artifact", export)
    monkeypatch.setattr(os.path, "getsize", lambda p: 0)
    art = str(tmp_path / "m.onetx")
    TR.main(["export-artifact", "--model", work["ck"], "--out", art,
             "--input-sz", str(HW)] + CPU)
    monkeypatch.undo()
    p, s, _ = load_onet_auto(work["ck"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves([p, s]), tree_leaves([seen.pop("params"),
                                          seen.pop("bn")])))
    assert seen == dict(out=art, input_hw=(HW, HW), in_channels=1,
                        batch=None, policy=BF16_COMPUTE, int8_calib=None,
                        extra_meta={"model": "ck_epoch_3.npz"},
                        device=torch.device("cpu"))
    assert "device cpu" in capsys.readouterr().out

    with torch.no_grad():
        folded = fold_onet(p, s)
    calls = []

    def program(x):
        calls.append(tuple(x.shape))
        with torch.no_grad():
            return onet_infer(folded, x, policy=BF16_COMPUTE)

    meta = {"arithmetic": "bfloat16", "batch": "symbolic",
            "input_hw": [HW, HW], "in_channels": 1, "model": "ck"}
    monkeypatch.setattr(artifact, "is_artifact", lambda path: path == art)
    monkeypatch.setattr(artifact, "load_serving_artifact",
                        lambda path, device=None: (program, meta))
    out = str(tmp_path / "am.npz")
    TR.main(["serve", "--model", art, "--input", work["frames"],
             "--serve-batch", "2", "--out", out] + CPU)
    assert calls == [(2, HW, HW, 1)] * 3
    assert np.array_equal(_npz(out)["masks"],
                          _library_masks(work, _npz(work["frames"])["imgs"]))


def _zy3_files(tmp_path, n_train=6, n_test=3):
    from onet_tpu_torch.data.export import export_zy3_pt
    from onet_tpu_torch.data.zy3 import synthesize_zy3

    files = []
    for seed, n in ((10, n_train), (11, n_test)):
        ds, ids = synthesize_zy3(make_generator(seed, "cpu"), n=n, size=HW,
                                 device="cpu")
        files.append(str(tmp_path / f"zy3_{seed}.pt"))
        export_zy3_pt(files[-1], ds, [f"17000000{seed}{i}"
                                      for i in range(n)])
    return files


def _zy3_library(tmp_path, train_ds, test_ds, test_ids, **cfg):
    from onet_tpu_torch.run import _groups
    from onet_tpu_torch.train.zy3 import (Zy3Config, save_zy3_test_results,
                                          train)
    config = Zy3Config(**dict(dict(epoch_nums=1, batch_sz=3,
                                   base_channels=8,
                                   out_root=str(tmp_path / "lib")), **cfg))
    p, s, _ = train(config, train_ds, test_ds, policy=BF16_COMPUTE,
                    device="cpu")
    _, summary = save_zy3_test_results(
        str(tmp_path / "lib" / "r.xlsx"), p, s, test_ds, test_ids,
        _groups(test_ids), batch_sz=3, policy=BF16_COMPUTE,
        model_name=config.model_name)
    return summary.to_string(index=False).splitlines()


@pytest.mark.parametrize("case", ["files", "restart", "cloud_addition"])
def test_zy3_matches_library(tmp_path, case, monkeypatch, capsys):
    from onet_tpu_torch.data import zy3 as Z
    from onet_tpu_torch.data.arrays import ArrayDataset

    cli = str(tmp_path / "cli")
    yml = _yaml(tmp_path, "zy3", epoch_nums=1, batch_sz=3, out_root=cli,
                dataset_root=str(tmp_path / "none"))
    argv = ["zy3", "--config", yml, "--base-channels", "8"] + CPU
    cfg = {}
    if case == "cloud_addition":
        real = Z.synthesize_cloud_addition
        monkeypatch.setattr(Z, "synthesize_cloud_addition",
                            functools.partial(real, size=HW))
        argv += ["--cloud-addition", "--n-train", "6", "--n-test", "3"]
        tr, _ = real(make_generator(0, "cpu"), n=6, size=HW, device="cpu")
        te, test_ids = real(make_generator(1, "cpu"), n=3, size=HW,
                            device="cpu")
        sets = [ArrayDataset({"imgs": d["imgs"], "labels": d["labels"]})
                for d in (tr, te)]
        cfg["model_name"] = "onet_vanilla_zy3_cloudadd"
    else:
        train_pt, test_pt = _zy3_files(tmp_path)
        argv += ["--train-file", train_pt, "--test-file", test_pt]
        sets = [Z.load_zy3_dict_pt(f, device="cpu") for f in
                (train_pt, test_pt)]
        test_ids = sets[1][1]
        sets = [s for s, _ in sets]
    if case == "restart":
        start = str(tmp_path / "start.npz")
        p, s = onet_init(torch.Generator().manual_seed(8), 3, base=8,
                         device="cpu")
        save_checkpoint(start, p, s, 0)
        argv += ["--restart-from", start, "--epochs", "2"]
        cfg.update(restart_from=start, epoch_nums=2)
    TR.main(argv)
    got = _lines(capsys)
    want = _zy3_library(tmp_path, *sets, test_ids, **cfg)
    assert got[-len(want):] == want
    assert any(line.startswith("[zy3] report: ") for line in got)
    _same_checkpoints(cli, str(tmp_path / "lib"))


def _scenes(tmp_path, n=3, size=48):
    from onet_tpu_torch.data.zy3 import synthesize_zy3
    from onet_tpu_torch.runs.reproduce_all import write_scenes

    ds, _ = synthesize_zy3(make_generator(4, "cpu"), n=n, size=size,
                           device="cpu")
    src, masks = str(tmp_path / "src"), str(tmp_path / "masks")
    write_scenes(src, masks, ds["imgs"].numpy(), ds["labels"].numpy(),
                 [f"{1710000000 + i}" for i in range(n)])
    return src, masks


def test_prepare_zy3_matches_library(tmp_path, capsys):
    from onet_tpu_torch.preprocess.onramp import (list_scene_files,
                                                  prepare_zy3_thumbnails,
                                                  save_zy3_dict)
    src, masks = _scenes(tmp_path)
    out = str(tmp_path / "cli.pt")
    TR.main(["prepare-zy3", "--src", src, "--masks", masks, "--out", out,
             "--pre-option", "haze_remove", "--resize-to", "40", "--crop",
             str(HW), "--id-prefix", "zy3_test_"] + CPU)
    assert "[prepare-zy3] 3 scenes" in capsys.readouterr().out
    prepared, _ = prepare_zy3_thumbnails(
        list_scene_files(src), list_scene_files(masks),
        pre_option="haze_remove", resize_to=40, crop=HW, device="cpu")
    ref = save_zy3_dict(str(tmp_path / "lib.pt"), prepared,
                        id_prefix="zy3_test_")
    a, b = (torch.load(p, weights_only=False) for p in (out, ref))
    assert list(a) == list(b)
    for k in b:
        assert list(a[k]) == list(b[k])
        assert all(torch.equal(a[k][f], b[k][f]) for f in b[k]
                   if isinstance(b[k][f], torch.Tensor))


def test_choose_preprocess_matches_library(work, tmp_path, capsys,
                                           monkeypatch):
    from onet_tpu_torch.core.checkpoint import load_arch_auto
    from onet_tpu_torch.preprocess.onramp import (choose_preprocess,
                                                  list_scene_files)
    from onet_tpu_torch.run import _groups

    from onet_tpu_torch.preprocess import onramp

    # thumbnails at 32^2 (the command takes the 300 -> 224 defaults)
    monkeypatch.setattr(onramp, "choose_preprocess", functools.partial(
        onramp.choose_preprocess, resize_to=40, crop=HW))
    src, masks = _scenes(tmp_path)
    yml = _yaml(tmp_path, "zy3", out_root=str(tmp_path / "out"))
    out_dict = str(tmp_path / "best.pt")
    TR.main(["zy3", "--config", yml, "--choose-preprocess", src,
             "--choose-masks", masks, "--model", work["rgb"],
             "--out-dict", out_dict] + CPU)
    got = _lines(capsys)
    _, p, s, _ = load_arch_auto(work["rgb"], "cpu")
    files = list_scene_files(src)
    ids = ["zy3_test_" + os.path.basename(f)[6:-4] for f in files]
    best, rows = choose_preprocess(p, s, files, list_scene_files(masks),
                                   groups=_groups(ids), policy=BF16_COMPUTE,
                                   resize_to=40, crop=HW, device="cpu")
    assert [line for line in got if ",\t input," in line] == [
        "%s,\t input,%10s,acc,%.4f,miou,%.4f, classified type, %s"
        % (r["img_id"], r["opt"], r["acc"], r["miou"], r["classified_type"])
        for r in rows]
    saved = torch.load(out_dict, weights_only=False)
    assert list(saved) == list(best)
    for k, rec in best.items():
        assert saved[k]["opt"] == rec["opt"]
        assert torch.equal(saved[k]["true_color"],
                           rec["img"].permute(2, 0, 1))


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """The infoseg and iic commands' printed evals and checkpoints."""
    import contextlib
    import io
    root = tmp_path_factory.mktemp("baselines")
    out = {}
    for cmd in ("infoseg", "iic"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            TR.main([cmd, "--input-sz", str(HW), "--base-channels", "8",
                     "--frames-per-level", "1", "--epochs", "1",
                     "--batch-sz", "2", "--out-root", str(root / cmd)]
                    + CPU)
        out[cmd] = (buf.getvalue().splitlines()[-1],
                    glob.glob(str(root / cmd / "*.npz"))[0])
    return out


@pytest.mark.parametrize("cmd", ["infoseg", "iic"])
def test_baselines_match_library(baselines, cmd, tmp_path):
    from onet_tpu_torch.train import iic, infoseg
    mod, cls = ((infoseg, infoseg.InfoSegConfig) if cmd == "infoseg"
                else (iic, iic.IICConfig))
    cfg = cls(input_sz=HW, base_channels=8, frames_per_level=1,
              epoch_nums=1, batch_sz=2, out_root=str(tmp_path))
    _, _, hist = mod.train(cfg, policy=BF16_COMPUTE, log=False,
                           device="cpu")
    line, ckpt = baselines[cmd]
    assert line == str({k: round(float(v), 4)
                        for k, v in hist["eval"][0].items()})
    _same_checkpoints(os.path.dirname(ckpt), str(tmp_path))


def test_nau_matches_library(work, baselines, tmp_path, capsys):
    from onet_tpu_torch.core.checkpoint import (load_checkpoint,
                                                load_onet_auto)
    from onet_tpu_torch.data.export import export_nau_pt
    from onet_tpu_torch.data.nau import load_nau_dict_pt, synthesize_nau_rain
    from onet_tpu_torch.metrics.cfar import cfar_seg_batch
    from onet_tpu_torch.metrics.segmentation import (
        align_labels_hungarian, evaluate_binary_segmentation)
    from onet_tpu_torch.models.infoseg import (get_label, infoseg_forward,
                                               infoseg_init)
    from onet_tpu_torch.train.nau import make_transfer_eval, test_naurain
    from onet_tpu_torch.train.two_stage import make_two_stage_eval

    ds, ids = synthesize_nau_rain(make_generator(3, "cpu"), n=4, size=HW,
                                  device="cpu")
    pt = str(tmp_path / "nau.pt")
    export_nau_pt(pt, ds, ids)
    yml = _yaml(tmp_path, "naurain", batch_sz=2,
                out_root=str(tmp_path / "out"))
    TR.main(["nau", "--config", yml, "--test-file", pt, "--model",
             work["ck"], "--cfar", "2", "--infoseg", baselines["infoseg"][1],
             "--model2", work["ck"], "--model-tw", work["tw"],
             "--base-channels", "8"] + CPU)
    got = _lines(capsys)
    ds, ids = load_nau_dict_pt(pt, device="cpu")
    p, s, _ = load_onet_auto(work["ck"], "cpu")
    r = lambda m: {k: round(float(v), 4) for k, v in m.items()}  # noqa
    labels = ds["labels"].to(torch.int32)
    assert got[1] == str(r(test_naurain(p, s, ds, batch_sz=2,
                                        policy=BF16_COMPUTE, ids=ids)))
    ip, ist = infoseg_init(torch.Generator().manual_seed(0), 1, base=8,
                           device="cpu")
    ip, ist, _ = load_checkpoint(baselines["infoseg"][1], ip, ist)
    with torch.no_grad(), BF16_COMPUTE.precision():
        pred = align_labels_hungarian(get_label(infoseg_forward(
            ip, ist, ds["imgs"], train=False,
            policy=BF16_COMPUTE)[0].probs), labels)
    assert got[2].endswith(str(r(evaluate_binary_segmentation(pred,
                                                              labels))))
    assert got[3].endswith(str(r(evaluate_binary_segmentation(
        cfar_seg_batch(ds["imgs"], 2.0), labels))))
    tw = load_onet_auto(work["tw"], "cpu")[:2]
    pred = make_transfer_eval(policy=BF16_COMPUTE)(
        *tw, ds["imgs"], ds["labels"])[2]
    assert got[4].endswith(str(r(evaluate_binary_segmentation(pred,
                                                              labels))))
    m2 = make_two_stage_eval(policy=BF16_COMPUTE)(
        p, s, p, s, ds["imgs"], ds["labels"])[1]
    assert got[5].endswith(str(r(m2)))
