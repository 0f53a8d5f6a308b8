"""The port's single-file serving artifact (onet_tpu_torch/serve/artifact.py)
against the live folded graph and the JAX package's ``onet_infer``, on
the CPU, in fp32.

Setup: base 8, 32x32 frames, weights drawn with numpy (non-trivial BN
statistics) and carried into both packages; two artifacts exported once
per module (a symbolic batch and a pinned batch of 4). Tolerances: the
artifact's S within 1e-6 of the live stacked graph it was exported from
and its labels equal (one graph, traced); its S within 2e-5 of JAX's
``onet_infer`` on the same weights (float32 reassociation through ~20
conv layers, as tests/test_torch_infer.py holds the live graph). Every
malformed file raises ValueError with the JAX package's wording; a JAX
artifact is named as one.
"""

import json
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.core.policy import DEFAULT as J_DEFAULT
from onet_tpu.models.infer import fold_onet as j_fold, onet_infer as j_infer
from onet_tpu.models.onet import onet_init as j_init
from onet_tpu.serve import artifact as JA

from onet_tpu_torch.core.bridge import from_jax_numpy
from onet_tpu_torch.core.policy import DEFAULT
from onet_tpu_torch.models.infer import fold_onet, onet_infer
from onet_tpu_torch.serve import artifact as TA
from onet_tpu_torch.serve.http import ServingSession

HW = (32, 32)
J_INFER = jax.jit(lambda f, x: j_infer(f, x, policy=J_DEFAULT))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(JAX params, JAX state) as numpy, and the port's (params, state)."""
    shapes = jax.eval_shape(lambda: j_init(jax.random.key(0), 1, base=8))
    rng = np.random.default_rng(7)

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

    jp, js = (jax.tree_util.tree_map_with_path(draw, t) for t in shapes)
    return (jp, js), from_jax_numpy(jp, js, device="cpu")


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """{'symbolic': (path, meta), 'pinned': (path, meta)}."""
    root = tmp_path_factory.mktemp("artifact")
    out = {}
    for name, batch in (("symbolic", None), ("pinned", 4)):
        path = str(root / f"{name}.onetp")
        meta = TA.export_serving_artifact(
            *model[1], path, input_hw=HW, in_channels=1, batch=batch,
            policy=DEFAULT, device="cpu")
        out[name] = (path, meta)
    return out


@pytest.fixture(scope="module")
def symbolic(artifacts):
    """The symbolic artifact loaded once: (call, meta)."""
    return TA.load_serving_artifact(artifacts["symbolic"][0], device="cpu")


def _frames(b, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, *HW, 1)).astype(np.float32)


@pytest.mark.parametrize("b", [2, 3])
def test_symbolic_batch_roundtrip(model, artifacts, symbolic, b):
    (jp, js), (tp, ts) = model
    call, meta = symbolic
    assert meta == artifacts["symbolic"][1] and meta["batch"] == "symbolic"
    x = _frames(b, seed=b)
    s, labels = call(x)
    assert s.dtype == torch.float32 and labels.dtype == torch.int32
    assert s.shape == (b, *HW, 2) and labels.shape == (b, *HW)
    s_live, l_live = onet_infer(fold_onet(tp, ts), torch.from_numpy(x),
                                policy=DEFAULT, pair_pack=False)
    torch.testing.assert_close(s, s_live, atol=1e-6, rtol=0)
    assert torch.equal(labels, l_live.to(torch.int32))
    s_jax, _ = J_INFER(jax.jit(j_fold)(jp, js), jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_jax), atol=2e-5,
                               rtol=0)
    # the artifact's call serves behind a session as the live step does
    sess = ServingSession(lambda _, xb: call(xb), None, batch=b,
                          in_channels=1, mode="fp32", device="cpu")
    masks, _ = sess.segment(x)
    np.testing.assert_array_equal(masks, labels.numpy().astype(np.uint8))


def test_header_and_is_artifact(model, artifacts):
    path, meta = artifacts["symbolic"]
    assert TA.read_artifact_meta(path) == meta
    assert meta["input_hw"] == [32, 32] and meta["in_channels"] == 1
    assert meta["header_version"] == 1 and meta["device"] == "cpu"
    assert meta["arithmetic"] == "float32" and meta["bias"] == 0.0
    assert meta["params_m"] == round(
        sum(t.size for t in jax.tree.leaves(model[0][0])) / 1e6, 4)
    assert meta["torch_version"] == torch.__version__
    assert len(meta["blob_sha256"]) == 64
    assert TA.is_artifact(path) and not TA.is_artifact(__file__)
    assert not TA.is_artifact(path + ".missing")


def test_pinned_batch_and_shape_validation(artifacts):
    path, meta = artifacts["pinned"]
    assert meta["batch"] == 4
    call, _ = TA.load_serving_artifact(path, device="cpu")
    assert call(np.zeros((4, *HW, 1), np.float32))[1].shape == (4, *HW)
    with pytest.raises(ValueError, match="pinned batch"):
        call(np.zeros((3, *HW, 1), np.float32))
    with pytest.raises(ValueError, match="static H/W/C"):
        call(np.zeros((4, 64, 64, 1), np.float32))
    with pytest.raises(ValueError, match="static H/W/C"):
        call(np.zeros((4, *HW, 3), np.float32))


def test_malformed_files_raise(artifacts, tmp_path):
    clean = open(artifacts["pinned"][0], "rb").read()
    flipped = bytearray(clean)
    flipped[-100] ^= 0xFF                   # a byte of the program
    cases = {"flip": (bytes(flipped), "checksum"),
             "short": (clean[:-1000], "checksum")}
    for name, (data, msg) in cases.items():
        p = tmp_path / f"{name}.onetp"
        p.write_bytes(data)
        with pytest.raises(ValueError, match=msg):
            TA.load_serving_artifact(str(p), device="cpu")
    for cut, msg in ((12, "16-byte prefix"),
                     (40, "truncated artifact header")):
        p = tmp_path / f"cut{cut}.onetp"
        p.write_bytes(clean[:cut])
        with pytest.raises(ValueError, match=msg):
            TA.read_artifact_meta(str(p))
    garbled = bytearray(clean)
    garbled[20] = 0xFF                      # inside the JSON header
    p = tmp_path / "garbled.onetp"
    p.write_bytes(bytes(garbled))
    with pytest.raises(ValueError, match="corrupted artifact header"):
        TA.read_artifact_meta(str(p))
    head = json.dumps({"header_version": 99}).encode()
    p = tmp_path / "future.onetp"
    p.write_bytes(TA.MAGIC + struct.pack("<Q", len(head)) + head)
    with pytest.raises(ValueError, match="upgrade this package"):
        TA.read_artifact_meta(str(p))
    p = tmp_path / "bad.onetp"
    p.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="not a serving artifact"):
        TA.read_artifact_meta(str(p))


def test_jax_artifact_is_named(tmp_path):
    path = str(tmp_path / "jax.onetx")
    JA.export_fn_artifact(
        lambda x: (jnp.concatenate([x, 1 - x], axis=-1),
                   (x[..., 0] > 0.5).astype(jnp.int32)),
        path, input_hw=(8, 8), in_channels=1, platforms=("cpu",))
    assert JA.is_artifact(path) and not TA.is_artifact(path)
    with pytest.raises(ValueError, match="a JAX serving artifact"):
        TA.read_artifact_meta(path)
    with pytest.raises(ValueError, match="not a torch one"):
        TA.load_serving_artifact(path, device="cpu")


def test_int8_calib_raises(model, tmp_path):
    """int8 artifacts are exported (tests/test_torch_quant.py), for the
    weight-shared model only, as in the JAX package: a twin model raises
    before anything is written."""
    tp, ts = model[1]
    with pytest.raises(ValueError, match="weight-shared"):
        TA.export_serving_artifact(
            {"top": tp["top"], "down": tp["top"]},
            {"top": ts["top"], "down": ts["top"]}, str(tmp_path / "q.onetp"),
            input_hw=HW, int8_calib=np.zeros((2, *HW, 1), np.float32),
            device="cpu")
    assert not (tmp_path / "q.onetp").exists()
