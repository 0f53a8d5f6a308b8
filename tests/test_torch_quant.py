"""The port's int8 serving path (onet_tpu_torch/models/quant.py,
ops/conv_i8.py) against the JAX package's (onet_tpu/models/quant.py), on
the CPU.

Setup: base 8, 32x32 frames with bright blobs, made with numpy; the model
is trained 30 steps by the port (a random init's masks sit on the softmax
knife-edge) and carried to JAX as numpy. The JAX runs are shared in
module fixtures.

Tolerances:
* the plain int8 convs equal JAX's int8 ``lax`` ops exactly in int32
  (float64 on integer codes is exact while |acc| < 2^53), including sums
  past 2^24, where float32 is not exact;
* their f32 epilogue and codes equal JAX's op-by-op arithmetic bit for
  bit (jitted XLA contracts ``acc * sw + b`` into one FMA, which rounds
  once; the port and the kernel round twice, as the un-jitted JAX does);
* ``quantize_folded`` leaf by leaf on the same scales: ``wq`` equal,
  ``sw`` and ``b`` within 1 ulp; ``calibrate`` within rtol 2e-2 (the bf16
  graph run by two libraries);
* ``onet_infer_q`` on the same ``q`` (JAX's, through the bridge): mask
  agreement >= 0.99; S within 0.05 everywhere with the int8 head, and
  with the bf16 head in 99% of pixels (the head convs' bf16 outputs
  differ by an ulp where the two libraries sum in other orders, and a
  moved code moves S most at the knife-edge pixels).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
import torch

from onet_tpu.models import quant as JQ

from onet_tpu_torch.core.bridge import quant_from_jax_numpy
from onet_tpu_torch.core.policy import BF16_COMPUTE
from onet_tpu_torch.models import quant as TQ
from onet_tpu_torch.models.infer import fold_onet, onet_infer
from onet_tpu_torch.models.onet import onet_init
from onet_tpu_torch.models.unet import tree_map
from onet_tpu_torch.ops import conv_i8 as CI
from onet_tpu_torch.serve import artifact as TA
from onet_tpu_torch.train.optim import adam_init
from onet_tpu_torch.train.steps import make_train_step

DN = ("NHWC", "HWIO", "NHWC")
J_INFER_Q = jax.jit(JQ.onet_infer_q, static_argnames=("head_bf16",))
# jitted: one compile, where op-by-op dispatch compiles every op
J_QUANTIZE = jax.jit(JQ.quantize_folded)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n, hw=32, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, hw, hw, 1)).astype(np.float32)
    x[:, 8:16, 8:16, :] += 1.5
    return np.clip(x, 0, 1)


def _numpy_tree(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


@pytest.fixture(scope="module")
def trained():
    """A base-8 Onet trained 30 steps by the port: (folded numpy tree,
    port folded tree, calibration frames)."""
    p, s = onet_init(torch.Generator().manual_seed(0), 1, base=8,
                     device="cpu")
    opt = adam_init(p)
    step = make_train_step()
    x = torch.from_numpy(_blobs(8))
    for _ in range(30):
        p, s, opt, _ = step(p, s, opt, x, 1e-3)
    with torch.no_grad():
        folded = fold_onet(p, s)
    return _numpy_tree(folded), folded, _blobs(8)


@pytest.fixture(scope="module")
def jax_q(trained):
    """JAX's calibration scales and int8 params on the trained model."""
    fnp, _, x = trained
    folded = jax.tree.map(jnp.asarray, fnp)
    scales = JQ.calibrate(folded, jnp.asarray(x))
    # op by op, as the JAX package's tests call it (jitted XLA turns the
    # division by 127 into a multiply: 2 ulps on sw)
    return scales, JQ.quantize_folded(folded, scales)


# ---------------------------------------------------------------------------
# the int8 convs
# ---------------------------------------------------------------------------

CONV_CASES = [
    ("3x3", 2, 16),      # inc.conv1 of a 1-channel model: K = 18
    ("3x3", 6, 8),       # inc.conv1 of an RGB model
    ("3x3", 128, 16),    # sums past 2^24
    ("T", 32, 8),
    ("T", 48, 12),
]


@pytest.mark.parametrize("kind,ci,co", CONV_CASES)
def test_plain_convs_equal_jax_int8_ops(kind, ci, co):
    rng = np.random.default_rng(ci + co)
    kh = 3 if kind == "3x3" else 2
    x = rng.integers(-127, 128, (2, 7, 9, ci)).astype(np.int8)
    w = rng.integers(-127, 128, (kh, kh, ci, co)).astype(np.int8)
    if ci == 128:
        x[0, :4, :4] = 127          # full-range window, full-range weights
        w[..., 0] = 127
    if kind == "3x3":
        ref = lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
            dimension_numbers=DN, preferred_element_type=jnp.int32)
        got = CI.conv3x3_i8(torch.from_numpy(x), torch.from_numpy(w))
    else:
        ref = lax.conv_transpose(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "VALID",
            dimension_numbers=DN, preferred_element_type=jnp.int32)
        got = CI.convT2x2_i8(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if ci == 128:
        assert int(got.abs().max()) > 2 ** 24


@pytest.mark.parametrize("requant", [None, "unsigned", "signed"])
@pytest.mark.parametrize("kind", ["3x3", "T"])
def test_epilogue_equals_jax_op_by_op(kind, requant):
    rng = np.random.default_rng(3)
    kh = 3 if kind == "3x3" else 2
    x = rng.integers(0, 128, (2, 9, 11, 32)).astype(np.int8)
    w = rng.integers(-127, 128, (kh, kh, 32, 24)).astype(np.int8)
    sw = (rng.uniform(0.5, 2, 24) * 1e-4).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    sn = rng.uniform(0.01, 0.05, 24).astype(np.float32)
    site = {"wq": jnp.asarray(w), "sw": jnp.asarray(sw), "b": jnp.asarray(b)}
    with jax.disable_jit():
        y = (JQ._conv_i8(jnp.asarray(x), site) if kind == "3x3"
             else JQ._convT_q(jnp.asarray(x), site))
        if requant == "unsigned":
            y = JQ._requant(y, jnp.asarray(sn))
        elif requant == "signed":
            y = JQ._requant_signed(y, jnp.asarray(sn))
    fn = CI.conv3x3_i8 if kind == "3x3" else CI.convT2x2_i8
    got = fn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw),
             torch.from_numpy(b), requant=requant,
             s_next=None if requant is None else torch.from_numpy(sn))
    assert got.dtype == (torch.float32 if requant is None else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(y))


def test_wrappers_check_their_arguments():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 8, 4), dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(TypeError):
        CI.conv3x3_i8(x.float(), w)
    with pytest.raises(ValueError):
        CI.conv3x3_i8(x, w[:2, :2])
    with pytest.raises(ValueError):
        CI.conv3x3_i8(x, w, s, requant="unsigned")       # no s_next
    with pytest.raises(ValueError):
        CI.conv3x3_i8(x, w, None, s)                     # bias, no scale
    with pytest.raises(ValueError):
        CI.convT2x2_i8(x, w[:2, :2], s, requant="both", s_next=s)


def test_int8_ops_trace_as_custom_ops():
    """torch.export records the two int8 convs as the custom ops (so an
    exported program launches the kernels)."""
    w = torch.ones((3, 3, 8, 4), dtype=torch.int8)
    wt = torch.ones((2, 2, 4, 4), dtype=torch.int8)
    s = torch.ones(4)

    class M(torch.nn.Module):
        def forward(self, x):
            h = CI.conv3x3_i8(x, w, s, requant="unsigned", s_next=s)
            return CI.convT2x2_i8(h, wt, s, s)

    x = torch.ones((2, 5, 5, 8), dtype=torch.int8)
    prog = torch.export.export(M(), (x,))
    targets = {str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"}
    assert {"onet_tpu_torch.conv3x3_i8.default",
            "onet_tpu_torch.convT2x2_i8.default"} <= targets
    torch.testing.assert_close(prog.module()(x), M()(x), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["3x3", "T"])
def test_two_code_epilogue_equals_two_requants(kind):
    """requant=("unsigned", "unsigned"): the plain version's two code
    tensors equal two "unsigned" calls, and (3x3) the JAX package's two
    ``_requant``s of one ``_conv_i8``, bit for bit."""
    rng = np.random.default_rng(4)
    kh = 3 if kind == "3x3" else 2
    x = rng.integers(0, 128, (2, 9, 11, 32)).astype(np.int8)
    w = rng.integers(-127, 128, (kh, kh, 32, 24)).astype(np.int8)
    sw = (rng.uniform(0.5, 2, 24) * 1e-4).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    sa, sb = (rng.uniform(0.01, 0.05, 24).astype(np.float32)
              for _ in range(2))
    fn = CI.conv3x3_i8 if kind == "3x3" else CI.convT2x2_i8
    t = [torch.from_numpy(a) for a in (x, w, sw, b, sa, sb)]
    ya, yb = fn(*t[:4], requant=("unsigned", "unsigned"), s_next=(t[4], t[5]))
    assert ya.dtype == yb.dtype == torch.int8
    for got, s in ((ya, t[4]), (yb, t[5])):
        assert torch.equal(got, fn(*t[:4], requant="unsigned", s_next=s))
    if kind == "3x3":
        site = {"wq": jnp.asarray(w), "sw": jnp.asarray(sw),
                "b": jnp.asarray(b)}
        with jax.disable_jit():
            y = JQ._conv_i8(jnp.asarray(x), site)
            want = [JQ._requant(y, jnp.asarray(s)) for s in (sa, sb)]
        np.testing.assert_array_equal(ya.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(yb.numpy(), np.asarray(want[1]))


# the int8 graph's launches at full width (base 64, 512^2, batch 8): site,
# transposed, x [n, h, w, ci], co
SITES_512 = [
    ("inc.conv1", False, (8, 512, 512, 2), 128),
    ("inc.conv2", False, (8, 512, 512, 128), 128),
    ("down1.conv1", False, (8, 256, 256, 128), 256),
    ("down1.conv2", False, (16, 256, 256, 128), 128),
    ("down2.conv1", False, (16, 128, 128, 128), 256),
    ("down2.conv2", False, (16, 128, 128, 256), 256),
    ("down3.conv1", False, (16, 64, 64, 256), 512),
    ("down3.conv2", False, (16, 64, 64, 512), 512),
    ("down4.conv1", False, (16, 32, 32, 512), 1024),
    ("down4.conv2", False, (16, 32, 32, 1024), 1024),
    ("up1.up", True, (16, 32, 32, 1024), 512),
    ("up1.conv1", False, (16, 64, 64, 1024), 512),
    ("up1.conv2", False, (16, 64, 64, 512), 512),
    ("up2.up", True, (16, 64, 64, 512), 256),
    ("up2.conv1", False, (16, 128, 128, 512), 256),
    ("up2.conv2", False, (16, 128, 128, 256), 256),
    ("up3.up", True, (16, 128, 128, 256), 128),
    ("up3.conv1", False, (16, 256, 256, 256), 128),
    ("up3.conv2", False, (16, 256, 256, 128), 128),
    ("up4.up", True, (8, 256, 256, 256), 128),
    ("up4.conv1", False, (8, 512, 512, 256), 128),
    ("up4.conv2", False, (8, 512, 512, 128), 128),
]
# odd shapes: W not a multiple of the box, past the last row, ci classes,
# co under 8, M under one tile
ODD_SHAPES = [
    (False, (1, 5, 200, 16), 24), (False, (2, 9, 40, 64), 130),
    (False, (1, 7, 3, 1024), 5), (False, (2, 33, 17, 6), 12),
    (False, (1, 4, 4, 2), 7), (False, (3, 13, 11, 48), 200),
    (True, (1, 3, 130, 16), 3), (True, (2, 9, 33, 128), 20),
    (True, (1, 2, 5, 1024), 64), (True, (1, 5, 13, 48), 100),
    (False, (1, 1, 1, 1), 1),
]


def _plan_holds(convt, xs, co, ck=None):
    """The kernel's plan at one shape: TMA's limits, a tile of 128 pixels
    that the grid's tiles cover once, K steps that cover K."""
    n, h, w, ci = xs
    p = CI.plan(n, h, w, ci, co, convt, ck)
    assert p.cip >= ci and p.cip - ci < 64 and p.cip % 16 == 0  # strides
    assert p.cip == 32 or p.cip % 64 == 0
    assert p.ck in (32, 64, 128) and p.cip % p.ck == 0
    assert p.bw * p.bh == 128 and p.bw & (p.bw - 1) == 0
    assert max(p.bw, p.bh, p.ck) <= 256                        # box dims
    assert (p.tx - 1) * p.bw < w <= p.tx * p.bw
    assert (p.ty - 1) * p.bh < h <= p.ty * p.bh
    assert p.bw >= min(w, 128)
    assert p.ncols == (4 if convt else 1) * co
    assert (p.ntn - 1) * 128 < p.ncols <= p.ntn * 128
    assert p.kpad == (1 if convt else 9) * p.cip
    assert p.grid == n * p.tx * p.ty * p.ntn < 2 ** 31
    return p


def test_plan_at_every_site_and_odd_shapes():
    """Full width: boxes of 1 x 128 pixels at W >= 128, 2 x 64 at 64,
    4 x 32 at 32, no channel padding but inc.conv1's (2 -> 32), 128-byte
    K steps (32 at inc.conv1); odd shapes and forced K steps hold the
    plan's invariants."""
    want_box = {512: (1, 128), 256: (1, 128), 128: (1, 128), 64: (2, 64),
                32: (4, 32)}
    for name, convt, xs, co in SITES_512:
        p = _plan_holds(convt, xs, co)
        assert (p.bh, p.bw) == want_box[xs[2]], name
        assert p.cip == (32 if name == "inc.conv1" else xs[3]), name
        assert p.ck == (32 if name == "inc.conv1" else 128), name
    for convt, xs, co in ODD_SHAPES:
        _plan_holds(convt, xs, co)
    for ck in (32, 64, 128):
        assert _plan_holds(False, (2, 9, 40, 256), 72, ck).ck == ck
    with pytest.raises(ValueError):
        CI.plan(1, 4, 4, 64, 8, False, ck=128)   # 128 does not divide 64
    with pytest.raises(ValueError):
        CI.plan(1, 4, 4, 256, 8, False, ck=16)   # no 16-byte step


def test_plan_at_base_8(monkeypatch):
    """Every int8 launch of a base-8 graph (32^2, and 50^2: odd mid-net)
    has a plan that holds, one launch a site (16 3x3 with the bf16 head,
    18 without, 4 transposed; the two-code sites once each)."""
    p, s = onet_init(torch.Generator().manual_seed(5), 1, base=8,
                     device="cpu")
    with torch.no_grad():
        tf = fold_onet(p, s)
    seen, real = [], CI.plain

    def record(x, w, scale, bias, s_next, mode, convt):
        seen.append((convt, tuple(x.shape), w.shape[3], mode))
        return real(x, w, scale, bias, s_next, mode, convt)

    monkeypatch.setattr(CI, "plain", record)
    for hw in (32, 50):
        x = torch.from_numpy(_blobs(2, hw))
        with torch.no_grad():
            q = TQ.quantize_folded(tf, TQ.calibrate(tf, x))
            for hb in (True, False):
                seen.clear()
                TQ.onet_infer_q(q, x, head_bf16=hb)
                assert sum(not c for c, *_ in seen) == (16 if hb else 18)
                assert sum(c for c, *_ in seen) == 4
                assert [m for *_, m in seen].count(CI.OUT_U8X2) == 3
                for convt, xs, co, _ in seen:
                    _plan_holds(convt, xs, co)


def _emulate(x, w, convt, ck=None):
    """The kernel's tiling, on the CPU: each CTA's K steps as TMA boxes
    (zeros outside x and past B's columns), their product, and the
    epilogue's row offsets and runs into y. Returns the int32 accumulator
    and how many times each element of y was written."""
    xk, b, p = CI.operands(x, w, convt, ck)
    n, h, wd, cip = xk.shape
    co = w.shape[3]
    bh, bw = p.bh, p.bw
    pad = torch.zeros((n, h + bh + 2, wd + bw + 2, cip), dtype=torch.float64)
    pad[:, 1:h + 1, 1:wd + 1] = xk.double()
    bpad = torch.zeros((p.ntn * 128, p.kpad), dtype=torch.float64)
    bpad[:p.ncols] = b.double()
    oshape = (n, 2 * h, 2 * wd, co) if convt else (n, h, wd, co)
    y = torch.zeros(oshape, dtype=torch.int64).view(-1)
    hits = torch.zeros_like(y)
    run = 2 * co if convt else p.ncols
    gap = 2 * wd * co if convt else 0
    taps = [(0, 0)] if convt else [(dy, dx) for dy in (-1, 0, 1)
                                   for dx in (-1, 0, 1)]
    for cta in range(p.grid):
        nt, mt = cta % p.ntn, cta // p.ntn
        x0, y0 = (mt % p.tx) * bw, (mt // p.tx) % p.ty * bh
        nb, n0 = mt // p.tx // p.ty, nt * 128
        acc = torch.zeros((128, 128), dtype=torch.float64)
        for t, (dy, dx) in enumerate(taps):
            for c0 in range(0, cip, p.ck):
                a = pad[nb, 1 + y0 + dy:1 + y0 + dy + bh,
                        1 + x0 + dx:1 + x0 + dx + bw, c0:c0 + p.ck]
                k0 = t * cip + c0
                acc += a.reshape(128, p.ck) @ bpad[n0:n0 + 128,
                                                   k0:k0 + p.ck].T
        for r in range(128):
            yy, xx = y0 + r // bw, x0 + r % bw
            if yy >= h or xx >= wd:
                continue
            off = (((nb * 2 * h + 2 * yy) * 2 * wd + 2 * xx) * co if convt
                   else ((nb * h + yy) * wd + xx) * co)
            cols = torch.arange(n0, min(n0 + 128, p.ncols))
            at = off + cols // run * gap + cols % run
            y[at] = acc[r, cols - n0].round().long()
            hits[at] += 1
    return y.view(oshape).to(torch.int32), hits


@pytest.mark.parametrize("convt,xs,co,ck", [
    (False, (2, 9, 40, 64), 130, None), (False, (1, 7, 3, 6), 5, None),
    (False, (1, 5, 200, 16), 24, None), (False, (2, 4, 9, 256), 12, 64),
    (False, (2, 3, 150, 128), 9, None), (False, (2, 5, 64, 256), 16, None),
    (True, (2, 9, 33, 128), 20, 32), (True, (1, 3, 130, 16), 3, None),
    (True, (1, 4, 6, 48), 8, None)])
def test_kernel_tiling_emulated_equals_plain(convt, xs, co, ck):
    """The tiling the kernel runs (plan, operand layout, box coordinates,
    row offsets and runs), modelled on the CPU, writes every output once
    and equals the plain accumulator."""
    rng = np.random.default_rng(sum(xs) + co)
    kh = 2 if convt else 3
    x = torch.from_numpy(rng.integers(-127, 128, xs).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (kh, kh, xs[3], co))
                         .astype(np.int8))
    y, hits = _emulate(x, w, convt, ck)
    assert bool((hits == 1).all())
    want = CI.plain(x, w, None, None, None, CI.OUT_I32, convt)
    assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_quant_w_equals_jax():
    w = np.random.default_rng(1).normal(size=(3, 3, 8, 16)).astype(
        np.float32) * 0.1
    wq_j, sw_j = JQ._quant_w(jnp.asarray(w))
    wq, sw = TQ._quant_w(torch.from_numpy(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j))
    np.testing.assert_array_max_ulp(sw.numpy(), np.asarray(sw_j), maxulp=1)
    err = (wq.float() * sw - torch.from_numpy(w)).abs().max()
    assert float(err) <= float(sw.max()) * 0.5 + 1e-7


def test_calibrate_matches_jax(trained, jax_q):
    _, folded, x = trained
    scales_j, _ = jax_q
    scales = TQ.calibrate(folded, torch.from_numpy(x))
    assert set(scales) == set(scales_j)
    for k, v in scales_j.items():
        np.testing.assert_allclose(scales[k].numpy(), v, rtol=2e-2,
                                   atol=1e-6, err_msg=k)


def test_quantize_folded_leaf_by_leaf(trained, jax_q):
    _, folded, _ = trained
    scales_j, q_j = jax_q
    q = TQ.quantize_folded(
        folded, {k: torch.tensor(np.asarray(v)) for k, v in scales_j.items()})
    assert set(q) == set(q_j)
    assert q["in_scale"] == np.float32(q_j["in_scale"]) == np.float32(1 / 127)
    for site in TQ.SITES:
        a, b = q_j[site], q[site]
        assert b["wq"].dtype == torch.int8
        np.testing.assert_array_equal(b["wq"].numpy(), np.asarray(a["wq"]),
                                      err_msg=site)
        for leaf in ("sw", "b"):
            np.testing.assert_array_max_ulp(b[leaf].numpy(),
                                            np.asarray(a[leaf]), maxulp=1)
    for site in ("inc.conv2.bf16", "up4.conv2.bf16"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(q[site][leaf].numpy(),
                                          np.asarray(q_j[site][leaf]))
    for k, v in q_j["scales"].items():
        np.testing.assert_array_max_ulp(q["scales"][k].numpy(),
                                        np.asarray(v), maxulp=1)


def _agree_and_s(q_j, x, head_bf16):
    """(mask agreement, |dS| of every pixel) of the port's onet_infer_q
    against JAX's on the same q (carried across by the bridge)."""
    s_j, l_j = J_INFER_Q(q_j, jnp.asarray(x), head_bf16=head_bf16)
    q = quant_from_jax_numpy(jax.tree.map(np.asarray, q_j), device="cpu")
    with torch.no_grad():
        s, labels = TQ.onet_infer_q(q, torch.from_numpy(x),
                                    head_bf16=head_bf16)
    assert s.shape == (*x.shape[:3], 2) and labels.shape == x.shape[:3]
    assert bool(torch.isfinite(s).all())
    agree = float((labels.numpy() == np.asarray(l_j)).mean())
    return agree, np.abs(s.numpy() - np.asarray(s_j))


@pytest.mark.parametrize("head_bf16", [True, False])
def test_onet_infer_q_matches_jax(trained, jax_q, head_bf16):
    _, folded, x = trained
    _, q_j = jax_q
    agree, ds = _agree_and_s(q_j, x, head_bf16)
    assert agree >= 0.99, agree
    if head_bf16:
        assert np.quantile(ds, 0.99) <= 0.05, np.quantile(ds, 0.99)
    else:
        assert ds.max() <= 0.05, ds.max()
    # and the port's int8 graph against its own bf16 folded graph (the
    # JAX package's contract, tests/test_quant.py)
    q = quant_from_jax_numpy(jax.tree.map(np.asarray, q_j), device="cpu")
    with torch.no_grad():
        s_q, l_q = TQ.onet_infer_q(q, torch.from_numpy(x),
                                   head_bf16=head_bf16)
        s_bf, l_bf = onet_infer(folded, torch.from_numpy(x),
                                policy=BF16_COMPUTE)
    assert float((l_q == l_bf).float().mean()) >= 0.95
    assert float((s_q - s_bf).abs().median()) < 0.05


@pytest.mark.parametrize("cin,hw", [(1, 50), (3, 32)])
def test_onet_infer_q_odd_and_rgb_shapes(cin, hw):
    """50x50 goes odd mid-net (25 -> 12 at down3: the pool crops, the
    decoder pads); cin = 3 is the ZY-3 shape (inc.conv1's K = 54)."""
    p, s = onet_init(torch.Generator().manual_seed(5), cin, base=8,
                     device="cpu")
    with torch.no_grad():
        tf = fold_onet(p, s)
    folded = jax.tree.map(jnp.asarray, _numpy_tree(tf))
    x = np.random.default_rng(6).uniform(0, 1, (2, hw, hw, cin)).astype(
        np.float32)
    q_j = J_QUANTIZE(folded, JQ.calibrate(folded, jnp.asarray(x)))
    agree, ds = _agree_and_s(q_j, x, True)
    assert agree >= 0.99, agree
    assert np.quantile(ds, 0.99) <= 0.05, np.quantile(ds, 0.99)
    # the port's own calibration and quantization run at these shapes too
    q = TQ.quantize_folded(tf, TQ.calibrate(tf, torch.from_numpy(x)))
    with torch.no_grad():
        s, _ = TQ.onet_infer_q(q, torch.from_numpy(x), head_bf16=False)
    assert s.shape == (2, hw, hw, 2) and bool(torch.isfinite(s).all())


def test_int8_artifact_serves_the_live_graph(trained, tmp_path):
    """export_serving_artifact(int8_calib=...) on the CPU: the program
    equals the live onet_infer_q on the same calibration."""
    _, folded, x = trained
    p, s = onet_init(torch.Generator().manual_seed(0), 1, base=8,
                     device="cpu")
    path = str(tmp_path / "q.onetp")
    meta = TA.export_serving_artifact(p, s, path, input_hw=(32, 32),
                                      int8_calib=x, head_bf16=False,
                                      device="cpu")
    assert meta["arithmetic"] == "int8" and meta["batch"] == "symbolic"
    call, meta_read = TA.load_serving_artifact(path, device="cpu")
    assert meta_read == meta
    with torch.no_grad():
        fp = fold_onet(p, s)
        q = TQ.quantize_folded(fp, TQ.calibrate(fp, torch.from_numpy(x)))
        s_live, l_live = TQ.onet_infer_q(q, torch.from_numpy(x[:3]),
                                         head_bf16=False)
    s_art, l_art = call(x[:3])
    assert s_art.dtype == torch.float32 and l_art.dtype == torch.int32
    torch.testing.assert_close(s_art, s_live, rtol=0, atol=0)
    assert torch.equal(l_art, l_live.to(torch.int32))
