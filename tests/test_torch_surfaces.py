"""The port's data and model surfaces against the JAX package's, on the
CPU: the bridge back to the reference (``export_torch_state`` /
``export_torch_checkpoint``, onet_tpu_torch/core/bridge.py), the ``.pt``
exporters (data/export.py), the tile store (data/tilestore.py) and the
dataset verifier (data/verify.py).

Setup: base 8 trees drawn with numpy (weight-shared and twin); datasets of
at most 4 frames of 16x16 to 32x32 from a numpy seed. Tolerances: state
dicts, ``.pt`` files and stores equal key for key, dtype for dtype and bit
for bit; the verifier's reports (issues, stats) equal JAX's; its one-batch
eval on the same weights (both inits patched to one numpy draw): loss
within 1e-5 of JAX's (relative; float32 reassociation at base 8) and the
mask share within two pixels of the batch.
"""

import gc
import os

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.core import torch_import as JB
from onet_tpu.data import export as JE
from onet_tpu.data import tilestore as JS
from onet_tpu.data import verify as JV
from onet_tpu.models import onet as JO

from onet_tpu_torch.core import bridge as TB
from onet_tpu_torch.data import export as TE
from onet_tpu_torch.data import tilestore as TS
from onet_tpu_torch.data import verify as TV
from onet_tpu_torch.data.nau import load_nau_dict_pt
from onet_tpu_torch.data.simclutter import load_simclutter_pt
from onet_tpu_torch.data.zy3 import load_zy3_dict_pt
from onet_tpu_torch.models.unet import tree_leaves
from onet_tpu_torch.ops._build import BUILD


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_trees(seed, cin=1, weight_share=True):
    """JAX-shaped (params, state) trees of numpy leaves, base 8."""
    shapes = jax.eval_shape(lambda: JO.onet_init(
        jax.random.key(0), cin, base=8, weight_share=weight_share))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "w":
            a = rng.standard_normal(s.shape) * np.sqrt(
                2.0 / np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return tuple(jax.tree_util.tree_map_with_path(draw, t) for t in shapes)


def _same(a, b, where="file"):
    """Two loaded .pt objects equal: dict keys in order, tensors in dtype,
    shape, layout (contiguous) and every bit, lists and strings."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.is_contiguous() and b.is_contiguous(), where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# the bridge back to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_share", [True, False])
def test_export_torch_state_matches_jax(weight_share):
    jp, js = _draw_trees(3, weight_share=weight_share)
    tp, ts = TB.from_jax_numpy(jp, js, device="cpu")
    got = TB.export_torch_state(tp, ts)
    want = JB.export_torch_state(jp, js)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu" and got[k].is_contiguous()
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        assert np.array_equal(got[k].numpy(), v), k
    back_p, back_s = TB.import_torch_state(got, device="cpu")
    assert set(back_p) == ({"top"} if weight_share else {"top", "down"})
    for a, b in zip([*tree_leaves(tp), *tree_leaves(ts)],
                    [*tree_leaves(back_p), *tree_leaves(back_s)]):
        assert torch.equal(a, b)


def test_export_torch_checkpoint_reads_in_both(tmp_path):
    jp, js = _draw_trees(4)
    tp, ts = TB.from_jax_numpy(jp, js, device="cpu")
    path = TB.export_torch_checkpoint(str(tmp_path / "m.pytorch"), tp, ts,
                                      epoch=7)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert set(blob) == {"net", "epoch"} and blob["epoch"] == 7
    p2, s2, epoch = TB.import_torch_checkpoint(path, device="cpu")
    assert epoch == 7
    for a, b in zip([*tree_leaves(tp), *tree_leaves(ts)],
                    [*tree_leaves(p2), *tree_leaves(s2)]):
        assert torch.equal(a, b)
    jp2, js2, jepoch = JB.import_torch_checkpoint(path)
    assert jepoch == 7
    for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((jp2, js2))):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# .pt exporters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    sim = {"imgs": rng.uniform(0, 1, (4, 16, 16, 1)).astype(np.float32),
           "labels": (rng.uniform(0, 1, (4, 16, 16)) > 0.8).astype(
               np.float32),
           "psnr": np.array([0, 0, 2, 2], np.int32)}
    zy3 = {"imgs": rng.uniform(0, 1, (3, 24, 24, 3)).astype(np.float32),
           "labels": (rng.uniform(0, 1, (3, 24, 24)) > 0.6).astype(
               np.float32)}
    nau = {"imgs": rng.uniform(0, 1, (3, 20, 20, 1)).astype(np.float32),
           "labels": (rng.uniform(0, 1, (3, 20, 20)) > 0.7).astype(
               np.float32)}
    torch_ = {name: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
              for name, d in (("sim", sim), ("zy3", zy3), ("nau", nau))}
    return {"sim": sim, "zy3": zy3, "nau": nau}, torch_


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("bg", ["rayleigh", "k"])
def test_simclutter_pt_matches_jax(data, tmp_path, bg):
    np_d, t_d = data
    mine = TE.export_simclutter_pt(str(tmp_path / "t.pt"), t_d["sim"], bg=bg)
    theirs = JE.export_simclutter_pt(str(tmp_path / "j.pt"), np_d["sim"],
                                     bg=bg)
    _same(_load(mine), _load(theirs))
    back = load_simclutter_pt(mine, device="cpu")
    assert torch.equal(back["imgs"], t_d["sim"]["imgs"])
    assert torch.equal(back["labels"], t_d["sim"]["labels"])
    assert back["psnr"].tolist() == [0, 0, 2, 2]


@pytest.mark.parametrize("ids, with_masks", [(None, True),
                                             (["a", "b", "c"], True),
                                             (["a", "b", "c"], False)])
def test_zy3_pt_matches_jax(data, tmp_path, ids, with_masks):
    np_d, t_d = data
    mine = TE.export_zy3_pt(str(tmp_path / "t.pt"), t_d["zy3"], ids,
                            with_masks=with_masks)
    theirs = JE.export_zy3_pt(str(tmp_path / "j.pt"), np_d["zy3"], ids,
                              with_masks=with_masks)
    _same(_load(mine), _load(theirs))
    back, back_ids = load_zy3_dict_pt(mine, device="cpu")
    assert back_ids == (ids or [f"{1700000000 + i}" for i in range(3)])
    assert torch.equal(back["imgs"], t_d["zy3"]["imgs"])
    assert ("labels" in back.data) == with_masks


@pytest.mark.parametrize("ids", [None, ["r0", "r1", "r2"]])
def test_nau_pt_matches_jax(data, tmp_path, ids):
    np_d, t_d = data
    mine = TE.export_nau_pt(str(tmp_path / "t.pt"), t_d["nau"], ids)
    theirs = JE.export_nau_pt(str(tmp_path / "j.pt"), np_d["nau"], ids)
    _same(_load(mine), _load(theirs))
    back, _ = load_nau_dict_pt(mine, device="cpu")
    assert torch.equal(back["labels"], t_d["nau"]["labels"])


# ---------------------------------------------------------------------------
# tile store
# ---------------------------------------------------------------------------

def _store_arrays(rng):
    """One array per store dtype, as numpy (JAX side) and torch."""
    f = rng.standard_normal((3, 5, 4)).astype(np.float32)
    out = {"f32": f,
           "u16": rng.integers(0, 65535, (7,), dtype=np.uint16),
           "i32": rng.integers(-2**31, 2**31 - 1, (2, 3), dtype=np.int32),
           "u8": rng.integers(0, 255, (4, 4, 1), dtype=np.uint8),
           "i64": rng.integers(-2**62, 2**62, (5,), dtype=np.int64),
           "bf16": f[0].astype(ml_dtypes.bfloat16)}
    return out


def _bits(a):
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _torch_of(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_tilestore_builds_into_the_port(tmp_path):
    assert TS.native_available()
    assert os.path.dirname(TS._lib_path()) == BUILD
    assert os.path.exists(TS._lib_path())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tilestore_crosses_both_ways(rng, tmp_path, writer):
    if not JS.native_available():
        pytest.skip("no C++ toolchain")
    arrays = _store_arrays(rng)
    path = str(tmp_path / "x.ts")
    if writer == "port":
        assert TS.save_store(path, {k: _torch_of(v)
                                    for k, v in arrays.items()}) == path
        back = JS.load_store(path)
        for k, v in arrays.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(_bits(back[k]), _bits(v))
    else:
        assert JS.save_store(path, arrays) == path
        back = TS.load_store(path, device="cpu")
        for k, v in arrays.items():
            want = _torch_of(v)
            assert back[k].dtype == want.dtype and back[k].shape == want.shape
            assert torch.equal(back[k].view(torch.uint8) if k == "u16"
                               else back[k],
                               want.view(torch.uint8) if k == "u16" else want)


def test_tilestore_zero_copy_and_copy(rng, tmp_path):
    arrays = {k: _torch_of(v) for k, v in _store_arrays(rng).items()}
    path = str(tmp_path / "zc.ts")
    TS.save_store(path, arrays)
    views = TS.load_store(path, copy=False, device="cpu")
    # the entries lie back to back in the mapping, in write order
    f, u16 = views["f32"], views["u16"]
    assert u16.data_ptr() - f.data_ptr() == f.numel() * 4
    copies = TS.load_store(path, device="cpu")
    assert copies["f32"].data_ptr() != f.data_ptr()
    keep = views["bf16"]
    del views, f, u16
    gc.collect()                       # the mapping lives while a view does
    assert torch.equal(keep, arrays["bf16"])
    for k, v in arrays.items():
        assert torch.equal(copies[k].view(torch.uint8) if k == "u16"
                           else copies[k],
                           v.view(torch.uint8) if k == "u16" else v)
    # other dtypes are stored as float32, as the JAX store does
    TS.save_store(path, {"f64": torch.arange(3, dtype=torch.float64)})
    got = TS.load_store(path, device="cpu")["f64"]
    assert got.dtype == torch.float32 and got.tolist() == [0.0, 1.0, 2.0]


def test_tilestore_corruption_detected(rng, tmp_path):
    path = str(tmp_path / "bad.ts")
    TS.save_store(path, {"x": torch.zeros(4, 4)})
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 0xFF                  # inside the entry table / header
    open(path, "wb").write(bytes(data))
    with pytest.raises(OSError):
        TS.load_store(path, device="cpu")


def test_tilestore_npz_fallback(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(TS, "_load", lambda: None)
    arrays = {"imgs": torch.rand(2, 4, 4, 1), "labels": torch.arange(3)}
    path = str(tmp_path / "fb.ts")
    written = TS.save_store(path, arrays)
    assert written == path + ".npz"
    back = TS.load_store(path, device="cpu")
    for k, v in arrays.items():
        assert torch.equal(back[k], v)
    with pytest.raises(TypeError, match="bfloat16"):
        TS.save_store(path, {"x": torch.zeros(2, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# the dataset verifier
# ---------------------------------------------------------------------------

def _bad_files(root):
    """Files the verifier must fault, by name."""
    out = {}
    p = str(root / "nhwc.pt")           # our layout, not the reference's
    torch.save({"rayleigh_imgs": torch.zeros(4, 32, 32, 1),
                "rayleigh_labels": torch.zeros(4, 32, 32),
                "psnr": [1, 1, 2, 2]}, p)
    out["nhwc"] = p
    imgs = np.zeros((2, 1, 16, 16), np.float32)
    imgs[0, 0, 0, 0] = np.nan
    p = str(root / "nan.pt")
    torch.save({"rayleigh_imgs": torch.from_numpy(imgs),
                "rayleigh_labels": torch.zeros(2, 16, 16)}, p)
    out["nan_no_psnr"] = p
    p = str(root / "levels.pt")
    torch.save({f"k{i}": {"true_color": torch.rand(3, 16, 16),
                          "mask": torch.full((16, 16), 0.5)}
                for i in range(2)}, p)
    out["levels"] = p
    p = str(root / "partial.pt")
    torch.save({"a": {"true_color": torch.rand(3, 8, 8),
                      "mask": torch.zeros(8, 8)},
                "b": {"true_color": torch.rand(3, 8, 8)}}, p)
    out["partial_masks"] = p
    p = str(root / "nau_hwc.pt")
    torch.save({"a": {"img": torch.rand(8, 8, 2), "label": torch.zeros(8, 8)},
                "b": {"img": torch.rand(8, 8, 2)}}, p)
    out["nau_hwc_nolabel"] = p
    p = str(root / "ragged.pt")         # JAX's verifier raises on these
    torch.save({"a": {"true_color": torch.rand(3, 8, 8),
                      "mask": torch.zeros(8, 8)},
                "b": {"true_color": torch.rand(3, 8, 9),
                      "mask": torch.zeros(8, 9)}}, p)
    out["ragged"] = p
    return out


@pytest.fixture(scope="module")
def verify_files(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("verify")
    _, t_d = data
    files = {"simclutter": TE.export_simclutter_pt(str(root / "sim.pt"),
                                                   t_d["sim"]),
             "zy3": TE.export_zy3_pt(str(root / "zy3.pt"), t_d["zy3"]),
             "nau": TE.export_nau_pt(str(root / "nau.pt"), t_d["nau"])}
    files.update(_bad_files(root))
    return files


def _report_sans_eval(r):
    return {k: v for k, v in r.items() if k != "eval"}


@pytest.mark.parametrize("name, workload", [
    ("simclutter", "auto"), ("zy3", "auto"), ("nau", "auto"),
    ("zy3", "nau"), ("nhwc", "auto"), ("nan_no_psnr", "auto"),
    ("levels", "auto"), ("partial_masks", "auto"),
    ("nau_hwc_nolabel", "auto")])
def test_verify_reports_match_jax(verify_files, name, workload):
    path = verify_files[name]
    got = TV.verify_dataset(path, workload, eval_batch=False)
    want = JV.verify_dataset(path, workload, eval_batch=False)
    assert repr(got) == repr(want)          # NaN stats compare as text
    assert got["ok"] == (name in ("simclutter", "zy3", "nau")
                         and workload == "auto")
    assert TV.format_report(got) == JV.format_report(want)


def test_verify_reports_ragged_shapes(verify_files):
    """Frames of two shapes are an issue to report: JAX's verifier stops
    at stacking them, the port's reports the issue and skips those
    stats."""
    path = verify_files["ragged"]
    with pytest.raises(ValueError, match="same shape"):
        JV.verify_dataset(path, eval_batch=False)
    got = TV.verify_dataset(path, eval_batch=False)
    assert not got["ok"] and "imgs" not in got and "labels" not in got
    assert got["issues"] == [
        f"inconsistent image shapes {({(3, 8, 8), (3, 8, 9)})}",
        "inconsistent mask shapes"]


def test_verify_unidentifiable_raises(tmp_path):
    for i, obj in enumerate(([1, 2, 3], {"foo": torch.zeros(3)},
                             {"a": {"x": torch.zeros(2)}})):
        p = str(tmp_path / f"junk{i}.pt")
        torch.save(obj, p)
        with pytest.raises(JV.ConformanceError) as je:
            JV.verify_dataset(p, eval_batch=False)
        with pytest.raises(TV.ConformanceError) as te:
            TV.verify_dataset(p, eval_batch=False)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["simclutter", "zy3"])
def test_verify_eval_matches_jax(verify_files, monkeypatch, name):
    """Both one-batch evals on one draw of weights: each package's init is
    patched to return it (JAX's draws cannot be made in torch)."""
    cin = 3 if name == "zy3" else 1
    jp, js = _draw_trees(21, cin=cin)
    bases = []

    def j_init(key, c, *, base, **kw):
        bases.append(("jax", c, base))
        return (jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, js))

    def t_init(gen, c, *, base, device=None, **kw):
        bases.append(("port", c, base))
        return TB.from_jax_numpy(jp, js, device=device)

    monkeypatch.setattr(JO, "onet_init", j_init)
    monkeypatch.setattr(TV, "onet_init", t_init)
    path = verify_files[name]
    want = JV.verify_dataset(path)
    got = TV.verify_dataset(path, device="cpu")
    assert bases == [("jax", cin, 8), ("port", cin, 8)]
    assert got["ok"] and want["ok"]
    assert _report_sans_eval(got) == _report_sans_eval(want)
    ge, we = got["eval"], want["eval"]
    assert ge["batch"] == [int(v) for v in we["batch"]]
    assert abs(ge["loss"] - we["loss"]) <= 1e-5 * abs(we["loss"])
    h, w = ge["batch"][1:3]
    assert abs(ge["mask_mean"] - we["mask_mean"]) <= 2.0 / (2 * h * w)
    assert "OK" in TV.format_report(got)
