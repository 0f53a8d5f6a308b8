"""The port's tiled scene serving (onet_tpu_torch/serve/tiles.py and the
daemon's ?scene=1) against the JAX package's (onet_tpu/serve/tiles.py),
on the CPU, in fp32.

Setup: base 8, weights drawn with numpy (non-trivial BN statistics, so
folding is exercised) and carried into both packages; scenes of at most
70x50 from a numpy seed. Tolerances: ``_plan`` equal; tiled masks equal
to JAX's wherever JAX's two class probabilities differ by at least 1e-4
(closer pixels may flip on float32 reassociation), and that near-tie set
is held under 5% of the scene (3.0% on the 32^2 windows of random
weights); the daemon's masks equal a direct ``infer_tiled`` call.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.core.policy import DEFAULT as J_DEFAULT
from onet_tpu.models.infer import fold_onet as j_fold, onet_infer as j_infer
from onet_tpu.models.onet import onet_init as j_init
from onet_tpu.serve import tiles as JT

from onet_tpu_torch.core.bridge import from_jax_numpy
from onet_tpu_torch.core.policy import DEFAULT
from onet_tpu_torch.models.infer import fold_onet, onet_infer
from onet_tpu_torch.serve import infer_tiled
from onet_tpu_torch.serve import tiles as TT
from onet_tpu_torch.serve.http import ServingSession, start_server

TIE = 1e-4
# one jitted JAX step per window shape, shared by every test
J_STEP = jax.jit(lambda f, x: j_infer(f, x, policy=J_DEFAULT))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors: where several test
    processes share the cores, a parallel region waits for threads that
    are not scheduled and a millisecond op takes tens of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folded():
    """The same folded weights as (JAX tree, port tree)."""
    shapes = jax.eval_shape(lambda: j_init(jax.random.key(0), 1, base=8))
    rng = np.random.default_rng(5)

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

    params, state = (jax.tree_util.tree_map_with_path(draw, t)
                     for t in shapes)
    jf = j_fold(jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, state))
    return jf, fold_onet(*from_jax_numpy(params, state, device="cpu"))


def _scene(h, w, seed=2):
    rng = np.random.default_rng(seed)
    scene = rng.uniform(0, 0.6, (h, w, 1)).astype(np.float32)
    for _ in range(3):
        cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
        scene[cy - 4:cy + 4, cx - 4:cx + 4] += 0.4
    return np.clip(scene, 0, 1)


def _port_step(f, xb):
    return onet_infer(f, xb, policy=DEFAULT)


def test_plan_matches_jax():
    for size in (1, 15, 16, 17, 31, 32, 33, 50, 70, 511, 512, 513, 2000,
                 3000):
        for tile in (1, 16, 48, 512):
            assert TT._plan(size, tile) == JT._plan(size, tile), (size, tile)


@pytest.mark.parametrize("h, w, tile, halo, batch", [
    (70, 50, 48, 8, 4),       # padded to the window in W, 4 windows
    (32, 32, 48, 8, 2),       # smaller than one window: one, padded
    (50, 37, 16, 8, 5),       # 12 windows, the last batch repeats
])
def test_infer_tiled_matches_jax(folded, h, w, tile, halo, batch):
    jf, tf = folded
    scene = _scene(h, w)
    kw = dict(tile=tile, halo=halo, batch=batch)
    want = JT.infer_tiled(J_STEP, jf, scene, **kw)
    # JAX's near ties, assembled by the same tiling
    tie = JT.infer_tiled(
        lambda f, x: (None, jnp.abs(jnp.diff(J_STEP(f, x)[0], axis=-1)
                                    )[..., 0] < TIE), jf, scene, **kw)
    got = infer_tiled(_port_step, tf, scene, device="cpu", **kw)
    assert got.shape == (h, w) and got.dtype == np.int32
    assert tie.mean() < 0.05
    np.testing.assert_array_equal(got[tie == 0], want[tie == 0])
    # a tensor scene gives the same mask
    again = infer_tiled(_port_step, tf, torch.from_numpy(scene),
                        device="cpu", **kw)
    np.testing.assert_array_equal(again, got)


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


@pytest.fixture(scope="module")
def daemon(folded):
    _, tf = folded
    sess = ServingSession(_port_step, tf, batch=3, in_channels=1,
                          mode="fp32", tile=16, halo=8, device="cpu")
    sess.warmup()
    httpd = start_server(sess, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield sess, tf, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.parametrize("normalize", [False, True])
def test_scene_query_matches_direct_call(daemon, normalize):
    sess, tf, url = daemon
    assert sess.input_hw == (32, 32)          # warmed at the window
    scenes = np.stack([_scene(50, 37, seed) for seed in (3, 4)])
    if normalize:
        scenes = 3.0 + 6.0 * scenes
    got = _post(url + "/segment?scene=1" + "&normalize=1" * normalize,
                scenes)
    assert got.shape == (2, 50, 37) and got.dtype == np.uint8
    for scene, m in zip(scenes, got):
        x = torch.from_numpy(scene)
        if normalize:
            lo, hi = x.amin(dim=(0, 1)), x.amax(dim=(0, 1))
            x = (x - lo) / (hi - lo + np.spacing(1.0))
        want = infer_tiled(_port_step, tf, x, tile=16, halo=8, batch=3,
                           device="cpu")
        np.testing.assert_array_equal(m, want.astype(np.uint8))
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        assert json.loads(resp.read())["tile"] == 16


def test_scene_query_without_tile_is_400(folded):
    _, tf = folded
    sess = ServingSession(_port_step, tf, batch=2, in_channels=1,
                          mode="fp32", device="cpu")
    httpd = start_server(sess, 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/segment?scene=1", np.zeros((40, 40), np.float32))
        assert e.value.code == 400
        assert json.loads(e.value.read())["error"] == (
            "ValueError: daemon started without --tile; ?scene=1 "
            "unavailable")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    assert sess.errors == 1
