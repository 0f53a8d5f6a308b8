"""The port's other model families (onet_tpu_torch/models/swin.py,
convnext.py, transunet.py, the stateless Onet container in models/onet.py
and their registry in models/arch.py) against the JAX package's, on the
CPU.

Geometries are the JAX tests' small ones: Swin window 2 / embed 12 (depths
2-1-1-1, so the shifted blocks run in the first stage and its decoder
mirror), ConvNeXt embed 16 (depths 1-1-2-1), TransUNet embed 96 / depth 1
/ img_size 64; frames [2, 64, 64, 1] from a numpy seed. The weights are
drawn once by the port's inits (the same laws as JAX's: a +-2 sigma
truncated normal, He normals, zeros, ones, the layer-scale 1e-6) and fed
to both packages; JAX's own jitted inits take 7-13 s a family to compile
on the CPU, more than the rest of this file. TransUNet's twin runs at
32x32, where the position table (4x4 tokens at init) is resized to 2x2.

Tolerances: loc, glob, V, Lsum and S in float32 within atol 2e-5 / rtol
1e-4 (the contract every onet_infer branch meets); the train step's loss
within 1e-5 and its gradient, as one vector, at cosine > 0.9999 with
JAX's; the weight-shared [2B] pass equal to the two branch passes within
1e-6; bf16 masks on the same weights agree with JAX's on >= 0.99 of the
pixels. Checkpoints are compared bit for bit.
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import onet_tpu.core.checkpoint as JCk
from onet_tpu.core.policy import BF16_COMPUTE as J_BF16
from onet_tpu.models import arch as JA
from onet_tpu.models import onet as JO

from onet_tpu_torch.core import checkpoint as TCk
from onet_tpu_torch.core.bridge import adam_state_from_jax
from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
from onet_tpu_torch.models import arch as TA
from onet_tpu_torch.models import onet as TO
from onet_tpu_torch.models.unet import tree_leaves
from onet_tpu_torch.ops.normalize import complement
from onet_tpu_torch.train import steps as TSteps

B, HW = 2, 64
FAMILIES = {
    "swin": dict(get=dict(swin_window=2, swin_embed=12),
                 apply=("onet_tpu.models.swin", "swin_unet_apply"),
                 hw=(HW, HW)),
    "convnext": dict(get=dict(convnext_embed=16),
                     init=dict(depths=(1, 1, 2, 1)),
                     apply=("onet_tpu.models.convnext",
                            "convnext_unet_apply"), hw=(HW, HW)),
    "transunet": dict(get=dict(transunet_embed=96, transunet_depth=1),
                      init=dict(img_size=64),
                      apply=("onet_tpu.models.transunet", "transunet_apply"),
                      hw=(HW, 32)),
}
NAMES = tuple(FAMILIES)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _port_init(name, weight_share):
    """The family at its test geometry, drawn by the port's init on the
    CPU: (params, state)."""
    from onet_tpu_torch.models import convnext, swin, transunet

    gen = torch.Generator().manual_seed(11 if weight_share else 12)
    if name == "swin":
        return swin.twin_init(
            lambda g: swin.swin_unet_init(g, 1, embed_dim=12, window=2,
                                          depths=(2, 1, 1, 1)),
            gen, weight_share, "cpu")
    if name == "convnext":
        return convnext.convnext_onet_init(
            gen, 1, weight_share=weight_share, embed_dim=16,
            depths=(1, 1, 2, 1), device="cpu")
    return transunet.transunet_onet_init(
        gen, 1, weight_share=weight_share, embed_dim=96, depth=1,
        img_size=64, device="cpu")


def _frames(hw, seed=5):
    return np.random.default_rng(seed).uniform(
        0, 1, (B, hw, hw, 1)).astype(np.float32)


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _jax_programs(name):
    """JAX's programs of one family on the test weights: the weight-shared
    net's Onet outputs, loss and gradient in float32 and its bf16 masks,
    and the twin's outputs with its top branch's apply (loc, glob)."""
    import importlib
    fam = FAMILIES[name]
    arch = JA.get_arch(name, **fam["get"])
    apply = getattr(importlib.import_module(fam["apply"][0]),
                    fam["apply"][1])
    hw_shared, hw_twin = fam["hw"]
    tp, ts = _port_init(name, True)
    tpt, tst = _port_init(name, False)

    def shared(p, x):
        def loss_of(p):
            o, _ = arch.forward(p, ts, x, train=True)
            return JO.compute_loss(o), o

        (loss, o), g = jax.value_and_grad(loss_of, has_aux=True)(p)
        return o.S, o.Vt, o.Vd, o.Lsum, o.Lt, loss, g

    def bf16(p, x):
        o16, _ = arch.forward(p, ts, x, train=False, policy=J_BF16)
        return JO.predict_label(o16.S)

    def twin(p, x):
        o, _ = arch.forward(p, tst, x, train=True)
        return o.S, o.Vt, apply(p["top"], x)   # the same top pass

    res = dict(params=tp, state=ts, x=_frames(hw_shared), twin_params=tpt,
               twin_state=tst, xt=_frames(hw_twin, seed=6))
    jp = _to_jax(tp)
    return res, ((shared, jp, res["x"]), (bf16, jp, res["x"]),
                 (twin, _to_jax(tpt), res["xt"]))


@pytest.fixture(scope="module")
def runs():
    """Per family, JAX's outputs on the same weights and frames as the
    port's. The programs compile in threads at once (XLA compiles outside
    the GIL): one after the other they take some 30 s on the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    cases = {name: _jax_programs(name) for name in NAMES}
    jobs = [(name, i, fn, p, x) for name, (_, progs) in cases.items()
            for i, (fn, p, x) in enumerate(progs)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(
            lambda j: jax.jit(j[2]).lower(j[3], j[4]).compile(), jobs))
    out = {name: res for name, (res, _) in cases.items()}
    for (name, i, _, p, x), exe in zip(jobs, compiled):
        got = _np(exe(p, x))
        if i == 0:
            out[name].update(zip(("S", "Vt", "Vd", "Lsum", "Lt", "loss",
                                  "grads"), got))
        elif i == 1:
            out[name]["mask16"] = got
        else:
            out[name].update(zip(("twin_S", "twin_Vt"), got[:2]),
                             loc=got[2][0], glob=got[2][1])
    return out


def _port(name, res, twin=False):
    arch = TA.get_arch(name, **FAMILIES[name]["get"])
    return (arch, res["twin_params" if twin else "params"],
            res["twin_state" if twin else "state"])


def _close(got, want, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", NAMES)
def test_onet_outputs_match_jax(runs, name):
    res = runs[name]
    arch, p, s = _port(name, res)
    with torch.no_grad():
        out, new_s = arch.forward(p, s, torch.tensor(res["x"]), train=True)
    for k in ("S", "Vt", "Vd", "Lsum", "Lt"):
        _close(getattr(out, k), res[k])
    assert new_s == {"top": {}}


@pytest.mark.parametrize("name", NAMES)
def test_twin_and_apply_match_jax(runs, name):
    """The twin's S and V, and *_unet_apply's (loc, glob) of its top
    branch."""
    import importlib
    res = runs[name]
    arch, p, s = _port(name, res, twin=True)
    assert set(p) == {"top", "down"} and s == {"top": {}, "down": {}}
    mod = importlib.import_module(
        FAMILIES[name]["apply"][0].replace("onet_tpu.", "onet_tpu_torch."))
    x = torch.tensor(res["xt"])
    with torch.no_grad():
        out, _ = arch.forward(p, s, x, train=True)
        loc, glob = getattr(mod, FAMILIES[name]["apply"][1])(p["top"], x)
    _close(out.S, res["twin_S"])
    _close(out.Vt, res["twin_Vt"])
    _close(loc, res["loc"])
    _close(glob, res["glob"])


@pytest.mark.parametrize("name", NAMES)
def test_stacked_pass_equals_branch_passes(runs, name):
    """The weight-shared [2B] pass against each branch run alone: no
    statistics across samples, so the two agree to float32 reassociation
    within a batch."""
    res = runs[name]
    arch, p, s = _port(name, res)
    apply = {"swin": "swin_unet_apply", "convnext": "convnext_unet_apply",
             "transunet": "transunet_apply"}[name]
    mod = __import__(f"onet_tpu_torch.models.{name}", fromlist=[apply])
    x = torch.tensor(res["x"])
    with torch.no_grad():
        out, _ = arch.forward(p, s, x)
        lt, ht = getattr(mod, apply)(p["top"], x)
        ld, hd = getattr(mod, apply)(p["top"], complement(x))
    vt, vd = TO.channel_dot(lt, ht), TO.channel_dot(ld, hd)
    s_seq = torch.softmax(torch.stack([vt, vd], -1), -1)
    for got, want in ((out.Lt, lt), (out.Ld, ld), (out.Vt, vt),
                      (out.Vd, vd), (out.S, s_seq)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_loss_and_gradient_match_jax(runs, name, monkeypatch):
    """make_train_step(forward=arch.forward): the gradient Adam receives,
    as one vector, against JAX's value_and_grad of the same objective."""
    res = runs[name]
    arch, p, s = _port(name, res)
    got = {}

    def capture(grads, opt_state, lr):
        got["grads"] = grads
        return TSteps.tree_map(torch.zeros_like, grads), opt_state

    monkeypatch.setattr(TSteps, "adam_update", capture)
    step = TSteps.make_train_step(forward=arch.forward)
    _, new_s, _, loss = step(p, s, None, torch.tensor(res["x"]), 1e-4)
    assert new_s == {"top": {}}
    assert abs(float(loss) - float(res["loss"])) <= 1e-5
    a = np.concatenate([t.numpy().ravel()
                        for t in tree_leaves(got["grads"])])
    b = np.concatenate([np.ravel(t) for t in jax.tree.leaves(res["grads"])])
    assert a.shape == b.shape
    assert a @ b > 0.9999 * np.linalg.norm(a) * np.linalg.norm(b)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_masks_agree_with_jax(runs, name):
    res = runs[name]
    arch, p, s = _port(name, res)
    with torch.no_grad(), BF16_COMPUTE.precision():
        out, _ = arch.forward(p, s, torch.tensor(res["x"]),
                              policy=BF16_COMPUTE)
    assert out.Lt.dtype == torch.bfloat16
    agree = float(np.mean(TO.predict_label(out.S).numpy() == res["mask16"]))
    assert agree >= 0.99, agree


def _registry_init(name, weight_share=True, seed=0):
    """The family at the registry's geometry (what a checkpoint's meta
    rebuilds), drawn by the port's init on the CPU."""
    arch = TA.get_arch(name, **FAMILIES[name]["get"])
    return arch.init(torch.Generator().manual_seed(seed), 1,
                     weight_share=weight_share, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_cross_packages_bit_equal(name, tmp_path):
    """JAX's file (twin params, empty branch state, Adam with list-bearing
    moments, meta) read by the port, and the port's read by JAX, leaf for
    leaf bit-equal, key for key the same; load_arch_auto rebuilds the
    family from the meta."""
    tp, ts = _registry_init(name, weight_share=False)
    jp = _to_jax(tp)
    js = ts
    assert js == {"top": {}, "down": {}}
    # optax's Adam state, built from numpy (JAX's eager ops would compile
    # one program a leaf shape)
    npp = jax.tree.map(np.asarray, jp)
    jopt = optax.ScaleByAdamState(
        count=np.asarray(3, np.int32),
        mu=jax.tree.map(lambda a: a * 0.5, npp),
        nu=jax.tree.map(lambda a: a * a, npp))
    meta = dict(arch=name, in_channels=1, weight_share=False,
                **FAMILIES[name]["get"])
    jfile = str(tmp_path / "jax.npz")
    JCk.save_checkpoint(jfile, jp, js, 4, opt_state=jopt, meta=meta)
    with np.load(jfile) as z:
        keys = set(z.files)
    first = {"swin": "p:top/enc0/0/attn/qkv/w",
             "convnext": "p:top/enc0/0/dw",
             "transunet": "p:top/blocks/0/qkv/w"}[name]
    assert first in keys
    assert "o:.mu/down/" + first[len("p:top/"):] in keys

    tp0, ts0 = _registry_init(name, weight_share=False, seed=1)
    topt = adam_state_from_jax(0, tp0, tp0, device="cpu")
    p2, s2, epoch, o2 = TCk.load_checkpoint(jfile, tp0, ts0,
                                            opt_template=topt)
    assert epoch == 4 and s2 == {"top": {}, "down": {}}
    for got, want in ((p2, jp), (o2["mu"], jopt.mu), (o2["nu"], jopt.nu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(o2["count"]) == 3

    a_arch, p3, s3, e3 = TCk.load_arch_auto(jfile, device="cpu")
    assert a_arch.name == name and not a_arch.vanilla and e3 == 4
    assert s3 == {"top": {}, "down": {}}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p3),
                                                 tree_leaves(p2)))

    tfile = str(tmp_path / "port.npz")
    TCk.save_checkpoint(tfile, p2, s2, 5, opt_state=o2, meta=meta)
    with np.load(tfile) as z:
        assert set(z.files) == keys
    jp2, js2, je2, jo2 = JCk.load_checkpoint(tfile, jp, js,
                                             opt_template=jopt)
    assert je2 == 5 and js2 == {"top": {}, "down": {}}
    for a, b in zip(jax.tree.leaves((jp2, jo2)),
                    jax.tree.leaves((jp, jopt))):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert JCk.read_checkpoint_meta(tfile) == meta


def test_mixed_family_checkpoint_dir_verifies(tmp_path):
    """Files of all four families, written by the JAX package, in one
    directory: verify_checkpoint_dir rebuilds each from its own file and
    reports what test_by_snr reports for that model."""
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.train.sweeps import test_by_snr, verify_checkpoint_dir

    models = {}
    for name in NAMES:
        p, s = _registry_init(name, seed=2)
        models[name] = (p, s)
        meta = dict(arch=name, in_channels=1, weight_share=True,
                    **FAMILIES[name]["get"])
        JCk.save_checkpoint(str(tmp_path / f"{name}_epoch_1.npz"),
                            _to_jax(p), s, 1, meta=meta)
    vp, vs = TA.get_arch().init(torch.Generator().manual_seed(3), 1,
                                base=8, device="cpu")
    JCk.save_checkpoint(str(tmp_path / "vanilla_epoch_2.npz"), _to_jax(vp),
                        _to_jax(vs), 2)
    models["vanilla"] = (vp, vs)
    rng = np.random.default_rng(9)
    ds = {lvl: ArrayDataset({
        "imgs": torch.tensor(rng.uniform(0, 1, (3, HW, HW, 1)),
                             dtype=torch.float32),
        "labels": torch.tensor(rng.uniform(0, 1, (3, HW, HW)) > 0.8,
                               dtype=torch.int32)}) for lvl in (0, 5)}
    report = verify_checkpoint_dir(str(tmp_path), datasets_by_psnr=ds,
                                   batch_sz=2, device="cpu")
    assert sorted(report) == sorted(os.path.basename(f) for f in
                                    glob.glob(str(tmp_path / "*.npz")))
    for f, rec in report.items():
        name = f.split("_epoch")[0]
        assert rec["arch"] == name
        assert rec["epoch"] == (2 if name == "vanilla" else 1)
        arch = TA.get_arch(name, **FAMILIES.get(name, {}).get("get", {}))
        p, s = models[name]
        assert rec["per_snr"] == test_by_snr(
            p, s, ds, batch_sz=2,
            forward=None if arch.vanilla else arch.forward)


def test_registry_refusals(runs, tmp_path):
    """base != 64, quantized training of another family, and BN folding,
    int8 quantization or a folded artifact of one: each refused with a
    message that names the cause."""
    from onet_tpu_torch.models.infer import fold_onet
    from onet_tpu_torch.serve.artifact import export_serving_artifact

    gen = torch.Generator().manual_seed(0)
    for name in NAMES:
        arch = TA.get_arch(name, **FAMILIES[name]["get"])
        with pytest.raises(ValueError, match="not --base-channels"):
            arch.init(gen, 1, base=32, device="cpu")
        with pytest.raises(ValueError, match="vanilla conv backbone"):
            TSteps.make_train_step(forward=arch.forward, quantized="fwd")
        _, p, s = _port(name, runs[name])
        with pytest.raises(ValueError, match="vanilla conv U-Net"):
            fold_onet(p, s)
        with pytest.raises(ValueError, match="vanilla conv U-Net"):
            export_serving_artifact(p, s, str(tmp_path / "a.onetp"),
                                    input_hw=(HW, HW), device="cpu")
        with pytest.raises(ValueError, match="vanilla conv U-Net"):
            export_serving_artifact(
                p, s, str(tmp_path / "a.onetp"), input_hw=(HW, HW),
                int8_calib=np.zeros((1, HW, HW, 1), np.float32),
                device="cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        TA.get_arch("vit")
    for cfg in ({"arch": "swin", "swin_window": 2, "swin_embed": 12},
                {"arch": "transunet", "transunet_embed": 96,
                 "transunet_depth": 2}):
        assert TA.arch_meta(type("C", (), dict(
            cfg, in_channels=1, weight_share=True,
            base_channels=64))()) == JA.arch_meta(type("C", (), dict(
                cfg, in_channels=1, weight_share=True,
                base_channels=64))())


def test_full_width_inits_match_the_published_geometry():
    """The defaults are Swin-T, ConvNeXt-T and ViT-B: the port's
    parameter counts equal the JAX package's (counted from its shapes,
    no draw), and the window is read back off the rpb tables."""
    from onet_tpu_torch.models.swin import _geometry
    from onet_tpu_torch.models.unet import param_count

    gen = torch.Generator().manual_seed(0)
    for name, kw in (("swin", dict(swin_window=8)), ("convnext", {}),
                     ("transunet", {})):
        p, _ = TA.get_arch(name, **kw).init(gen, 3, device="cpu")
        shapes = jax.eval_shape(lambda k: JA.get_arch(name, **kw).init(k, 3),
                                jax.random.key(0))[0]
        assert [tuple(t.shape) for t in tree_leaves(p)] == [
            tuple(a.shape) for a in jax.tree.leaves(shapes)]
        if name == "swin":
            assert _geometry(p["top"]) == ((3, 6, 12, 24), 8)
        assert param_count(p) == sum(int(np.prod(a.shape))
                                     for a in jax.tree.leaves(shapes))


@pytest.mark.parametrize("case", [((4, 4), (2, 2)), ((4, 4), (6, 6)),
                                  ((14, 14), (32, 32)), ((5, 7), (2, 3))])
def test_resize_is_jax_image_resize(case):
    """The position-table and CUP resize: F.interpolate(bilinear,
    antialias) in float32 equals jax.image.resize(bilinear) up and down."""
    from onet_tpu_torch.models.transunet import _resize

    src, dst = case
    a = np.random.default_rng(1).normal(size=(1, *src, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(a, (1, *dst, 8), method="bilinear"))
    np.testing.assert_allclose(_resize(torch.tensor(a), dst).numpy(), want,
                               atol=1e-6)


@pytest.mark.parametrize("side", [16, 17])
def test_same_stride2_conv_is_xla_same(side):
    """A 3x3 stride-2 SAME conv pads (0, 1) on an even side and (1, 1) on
    an odd one, as XLA does."""
    from onet_tpu.models.transunet import _conv as j_conv
    from onet_tpu_torch.models.transunet import _conv as t_conv

    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, side, side, 3)).astype(np.float32)
    p = {"w": rng.normal(size=(3, 3, 3, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    from onet_tpu.core.policy import DEFAULT as J_DEFAULT
    want = np.asarray(j_conv(x, p, 2, J_DEFAULT))
    got = t_conv(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()},
                 2, DEFAULT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_drivers_train_other_families(tmp_path, monkeypatch):
    """arch= through the drivers: simclutter's train(arch="swin") and the
    ZY-3 train(arch="transunet") from the test weights, one batch an
    epoch, against the same epochs stepped by hand with
    make_train_step(forward=) and the eval with make_eval_step(forward=) /
    make_zy3_eval(forward=); the final checkpoint carries the family's
    meta and reloads through load_arch_auto."""
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.models.unet import tree_map
    from onet_tpu_torch.train import simclutter as TS
    from onet_tpu_torch.train import zy3 as TZ
    from onet_tpu_torch.train.optim import adam_init, cosine_warm_restarts

    rng = np.random.default_rng(4)
    for name, mod, cfg_cls, chans in (("swin", TS, TS.SimclutterConfig, 1),
                                      ("transunet", TZ, TZ.Zy3Config, 1)):
        p0, s0 = _registry_init(name, seed=5)
        res = {"params": p0, "state": s0}
        imgs = rng.uniform(0, 1, (4, HW, HW, chans)).astype(np.float32)
        labels = (imgs[..., 0] > 0.7).astype(np.int32)
        ds = ArrayDataset({"imgs": torch.tensor(imgs),
                           "labels": torch.tensor(labels)})
        real = TA.get_arch

        def patched(*a, **kw):
            arch = real(*a, **kw)
            arch.init = lambda *a, **kw: (
                tree_map(torch.clone, res["params"]), res["state"])
            return arch

        monkeypatch.setattr(mod, "get_arch", patched)
        out = str(tmp_path / name)
        cfg = dict(model_name="m", epoch_nums=2, batch_sz=4, input_sz=HW,
                   in_channels=chans, save_epochs=(), arch=name,
                   out_root=out, **FAMILIES[name]["get"])
        if mod is TS:
            cfg["eval_every"] = 1
            tp, _, hist = TS.train(cfg_cls(**cfg), datasets=(ds, ds),
                                   log=False, device="cpu")
        else:
            cfg["aug"] = False
            tp, _, hist = TZ.train(cfg_cls(**cfg), ds, ds, log=False,
                                   device="cpu")
        monkeypatch.setattr(mod, "get_arch", real)

        arch = TA.get_arch(name, **FAMILIES[name]["get"])
        p = tree_map(torch.clone, res["params"])
        opt = adam_init(p)
        step = TSteps.make_train_step(forward=arch.forward)
        x, y = ds["imgs"], ds["labels"]
        for epoch in range(2):
            c = cfg_cls()
            lr = (TS.step_decay(c.base_lr, epoch) if mod is TS else
                  cosine_warm_restarts(c.base_lr, epoch))
            p, _, opt, loss = step(p, res["state"], opt, x, lr)
            assert abs(float(loss) - hist["loss"][epoch]) <= 1e-5 * max(
                1.0, abs(float(loss)))
        if mod is TS:
            ev = TSteps.make_eval_step(align="flip", forward=arch.forward)
            want = {k: float(v) for k, v in ev(p, res["state"], x,
                                               y)[0].items()}
        else:
            ev = TZ.make_zy3_eval(forward=arch.forward)
            want = {k: float(v.double().mean())
                    for k, v in ev(p, res["state"], x, y)[0].items()}
        for k, v in want.items():
            assert abs(hist["eval"][1][k] - v) <= 1e-6, (name, k)
        saved = glob.glob(os.path.join(out, "m_epoch*1_*.npz"))
        assert len(saved) == 1
        meta = TCk.read_checkpoint_meta(saved[0])
        assert meta["arch"] == name
        a2, p2, _, e2 = TCk.load_arch_auto(saved[0], device="cpu")
        assert a2.name == name and e2 == 1
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p2),
                                                     tree_leaves(tp)))
        # the driver's batch is a permutation of the hand-stepped one
        for a, b in zip(tree_leaves(tp), tree_leaves(p)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


def test_eval_surfaces_take_forward(runs):
    """make_transfer_eval, threshold_sweep_by_snr and the on-ramp's
    score_variants with forward=: each equal to the family's forward
    read directly."""
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.metrics.segmentation import accuracy
    from onet_tpu_torch.preprocess.curation import score_variants
    from onet_tpu_torch.train.nau import make_transfer_eval
    from onet_tpu_torch.train.sweeps import threshold_sweep_by_snr

    name = "convnext"
    res = runs[name]
    arch, p, s = _port(name, res)
    x = torch.tensor(res["x"])
    with torch.no_grad():
        out, _ = arch.forward(p, s, x)
    raw = TO.predict_label(out.S)
    labels = (x[..., 0] > 0.7).to(torch.int32)
    m, _, pred, (vt, _) = make_transfer_eval(forward=arch.forward)(
        p, s, x, labels)
    assert torch.equal(pred == raw, torch.full_like(raw, True)) or \
        torch.equal(pred, 1 - raw)
    assert float(vt.min()) == 0.0 and float(vt.max()) == 1.0
    rep = threshold_sweep_by_snr(
        p, s, {0: ArrayDataset({"imgs": x, "labels": labels})},
        far_budgets=(0.1,), forward=arch.forward)
    assert set(rep[0]) == {"argmax", "thresh"}
    accs, _ = score_variants(p, s, x, labels[0], forward=arch.forward)
    for i in range(B):
        assert float(accs[i]) == float(accuracy(raw[i], labels[0]))
