"""The port's parallel paths (onet_tpu_torch/parallel/, core/mesh.py and
train/steps.py on a mesh) against the JAX package, on the CPU in fp32.

One gloo world of 4 spawned CPU processes (tests/torch_parallel_worker.py)
runs every case; a case on 2 ranks uses ranks 0 and 1. Each rank takes the
same global batch and runs its block; its results come back as numpy.
The JAX side runs in this process on the same numpy weights (drawn by the
port's init) and frames: the single-device step on the global batch, its
``microbatches=M`` form for the pipeline, each jitted once in a module
fixture and compiled in threads at once; the collectives under
``shard_map`` on the virtual 8-device mesh; for one case, JAX's own GSPMD
data-parallel step.

The single-device steps run in float64 (x64, the package's float32 pins
raised to float64): this net's float32 gradient is ill-conditioned at
these sizes (BatchNorm over few values at the deep levels), and on these
frames JAX's own float32 gradient is 9.1e-4 (jsd) and 1.27e-3 (rsn) off
its float64 one, the port's single-device one 1.2e-4 and 1.4e-4: a
float32-to-float32 comparison would measure JAX's rounding.

Tolerances, the port in float32: loss within 1e-5 relative; gradient as
one vector, cosine > 0.9999 and relative L2 < 1e-3; BatchNorm state
within atol 1e-5, rtol 1e-3 (JAX's own bounds). Parameters after one Adam
step from zero moments move by -lr * g / (|g| + eps), about
-lr * sign(g): every update is at most lr, and the parameters are within
atol 1e-5, rtol 1e-3 of JAX's wherever JAX's gradient exceeds twice the
leaf's largest gradient difference between the packages (where float32
noise cannot flip the sign). Every rank's parameters, optimizer state and
BatchNorm state are bit-equal (a digest per rank).
"""

import concurrent.futures as cf

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import onet_tpu.core.policy as JP
from onet_tpu.core.mesh import make_mesh as j_make_mesh
from onet_tpu.core.mesh import batch_sharding as j_batch_sharding
from onet_tpu.core.mesh import replicated as j_replicated
from onet_tpu.models import onet as JO
from onet_tpu.parallel import multihost as JM
from onet_tpu.parallel.halo import validate_spatial_shapes as j_validate
from onet_tpu.train import optim as JOpt
from onet_tpu.train.steps import make_eval_step as j_make_eval_step
from onet_tpu.train.steps import make_train_step as j_make_train_step

from torch_parallel_worker import World

LR = 1e-4
X8 = np.random.default_rng(3).uniform(0, 1, (8, 32, 32, 1)).astype(
    np.float32)
X_WP = np.random.default_rng(5).uniform(0, 1, (4, 16, 16, 1)).astype(
    np.float32)
D, DS, DSW = ("data",), ("data", "space"), ("data", "space", "spacew")
DM, DST = ("data", "model"), ("data", "stage")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _vec(leaves):
    return np.concatenate([np.ravel(np.asarray(a, np.float64))
                           for a in leaves])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _j_step(params, state, x, loss="jsd", microbatches=1):
    """The JAX package's single-device step on the global batch (its
    train.steps.make_train_step body: value_and_grad of the loss, the
    microbatch scan, adam_update) in float64: x64, with the package's
    float32 pins raised to float64 (``_float64``, as
    tests/test_torch_train_wp.py's witness). Returns the loss, gradient,
    new BatchNorm state and parameters after Adam."""
    f64 = jnp.float64
    pol = JP.Policy(param_dtype=f64, compute_dtype=f64, norm_dtype=f64)
    loss_of = JO.LOSSES[loss]

    def grads_of(p, s, xb):
        def lf(pp):
            out, ns = JO.onet_forward(pp, s, xb, train=True, policy=pol,
                                      pair_pack=False)
            return loss_of(out), ns
        return jax.value_and_grad(lf, has_aux=True)(p)

    @jax.jit
    def f(p, s, xx):
        xm = xx.reshape(microbatches, -1, *xx.shape[1:])

        def micro(carry, xb):
            bn, gsum, lsum = carry
            (lv, nb), gg = grads_of(p, bn, xb)
            return (nb, jax.tree.map(jnp.add, gsum, gg), lsum + lv), None

        zeros = jax.tree.map(jnp.zeros_like, p)
        (ns, gsum, lsum), _ = lax.scan(micro, (s, zeros, f64(0.0)), xm)
        g = jax.tree.map(lambda a: a / microbatches, gsum)
        upd, _ = JOpt.adam_update(g, JOpt.adam_init(p), LR)
        return lsum / microbatches, g, ns, jax.tree.map(jnp.add, p, upd)

    with jax.enable_x64(True):
        cast = lambda t: jax.tree.map(                        # noqa: E731
            lambda a: jnp.asarray(a, f64), t)
        lv, g, ns, newp = f(cast(params), cast(state), jnp.asarray(x, f64))
        return dict(loss=float(lv), grads=_np(jax.tree.leaves(g)),
                    bn=_np(jax.tree.leaves(ns)),
                    params=_np(jax.tree.leaves(newp)))


def _j_f64(*args, **kw):
    """``_j_step`` in a process of its own: the float64 patch is global."""
    jnp.float32 = jnp.float64
    return _j_step(*args, **kw)


def _j_mesh_step(p, s, x):
    """JAX's own GSPMD data-parallel step (data 2) on the virtual mesh."""
    mesh = j_make_mesh(shape=(2, 1), devices=jax.devices()[:2])
    rep = j_replicated(mesh)
    put = lambda t: jax.device_put(jax.tree.map(jnp.asarray, t), rep)  # noqa
    jp, jb, _, jl = j_make_train_step(mesh=mesh)(
        put(p), put(s), put(JOpt.adam_init(p)),
        jax.device_put(jnp.asarray(x), j_batch_sharding(mesh)), LR)
    return dict(loss=float(jl), bn=_np(jax.tree.leaves(jb)),
                params=_np(jax.tree.leaves(jp)))


def _j_eval(p, s, x, labels, align):
    m, lv, pred = jax.jit(j_make_eval_step(align=align))(
        p, s, jnp.asarray(x), jnp.asarray(labels))
    return dict(metrics={k: float(v) for k, v in m.items()}, loss=float(lv),
                pred=np.asarray(pred))


def _halves():
    """8 frames whose two halves (the two data shards of mesh (2, 1)) have
    maxima 3x apart: rows 4-7 are three times rows 0-3's draws."""
    x = np.random.default_rng(13).uniform(0, 1, (8, 32, 32, 1))
    x[4:] *= 3.0
    return x.astype(np.float32)


XQ = _halves()
F32 = jnp.float32      # _j_f64 raises jnp.float32 in the pool's processes
LR_Q = 1e-3            # tests/test_torch_qtrain.py's
LEVELS = ("fwd", "fwd+dx")


def _j_qtrain(p, s, x, level, steps=3):
    """JAX's int8 training on the global batch ``x``: the one-device
    step's first loss and gradient (``make_train_step``'s loss through
    ``make_qtrain_ops``), and its GSPMD mesh step on (data 2) for
    ``steps`` Adam steps, the first conv's activation scale caught by a
    debug callback (the first ``_quant_act`` traced)."""
    from onet_tpu.models import qtrain as JT

    jnp.float32 = F32
    ops = JT.make_qtrain_ops(level=level)

    @jax.jit
    def grads_of(pp, ss, xx):
        def lf(q):
            out, _ = JO.onet_forward(q, ss, xx, train=True, ops=ops)
            return JO.LOSSES["jsd"](out)
        return jax.value_and_grad(lf)(pp)

    put = lambda t: jax.tree.map(jnp.asarray, t)          # noqa: E731
    lv, g = grads_of(put(p), put(s), jnp.asarray(x))
    seen, traced = [], []
    real = JT._quant_act

    def spy(v):
        q, sc = real(v)
        if not traced:                 # the first conv's scale only
            jax.debug.callback(lambda a: seen.append(np.asarray(a)), sc)
        traced.append(1)
        return q, sc

    JT._quant_act = spy
    try:
        mesh = j_make_mesh(shape=(2, 1), devices=jax.devices()[:2])
        rep = j_replicated(mesh)
        jp, jb = (jax.device_put(put(t), rep) for t in (p, s))
        jo = jax.device_put(JOpt.adam_init(jp), rep)
        step = j_make_train_step(mesh=mesh, quantized=level)
        losses = []
        for _ in range(steps):
            jp, jb, jo, jl = step(jp, jb, jo, jax.device_put(
                jnp.asarray(x), j_batch_sharding(mesh)), LR_Q)
            losses.append(float(jl))
        jax.effects_barrier()
    finally:
        JT._quant_act = real
    sx = seen[0]
    return dict(loss=float(lv), grads=_np(jax.tree.leaves(g)), sx=sx,
                mesh_losses=losses, mesh_params=_np(jax.tree.leaves(jp)))


def _port_model(base, seed):
    """Weights drawn by the port's init (JAX's jitted init compiles for
    seconds), as numpy for both packages."""
    import torch
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import tree_map

    p, s = onet_init(torch.Generator().manual_seed(seed), 1, base=base,
                     device="cpu")
    return tuple(tree_map(lambda t: t.numpy().copy(), t) for t in (p, s))


@pytest.fixture(scope="module")
def model8():
    return _port_model(8, 0)


@pytest.fixture(scope="module")
def model64():
    return _port_model(64, 11)


LABELS = (X8[..., 0] > 0.5).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(model8, model64):
    """Every JAX program of this file, each compiled and run in a spawned
    process of a pool, all started at once (the longest first): {name:
    future}."""
    import multiprocessing as mp
    p, s = model8
    jobs = {**{f"q_{lv}": (_j_qtrain, p, s, XQ, lv) for lv in LEVELS},
            "jsd": (_j_f64, p, s, X8),
            "rsn": (_j_f64, p, s, X8, "rsn"),
            "mb2": (_j_f64, p, s, X8, "jsd", 2),
            "mb4": (_j_f64, p, s, X8, "jsd", 4),
            "wp": (_j_f64, *model64, X_WP),
            "mesh": (_j_mesh_step, p, s, X8),
            "flip": (_j_eval, p, s, X8, LABELS, "flip"),
            "hungarian": (_j_eval, p, s, X8, LABELS, "hungarian")}
    ex = cf.ProcessPoolExecutor(4, mp_context=mp.get_context("spawn"))
    futs = {k: ex.submit(*job) for k, job in jobs.items()}
    yield futs
    ex.shutdown(cancel_futures=True)


@pytest.fixture(scope="module")
def oracles(jax_runs):
    return {k: jax_runs[k].result() for k in ("jsd", "rsn", "mb2", "mb4")}


def _check_train(ref, out, ranks, params0, grad_rel=1e-3):
    """Port ranks' results against the JAX step ``ref``."""
    res = out[ranks[0]]
    digests = {out[r]["digest"] for r in ranks}
    assert len(digests) == 1, "ranks hold different trees"
    assert all(out[r] is None for r in range(len(out)) if r not in ranks)
    np.testing.assert_allclose(res["loss"], ref["loss"], rtol=1e-5)
    a, b = _vec(ref["grads"]), _vec(res["grads"])
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    cos = (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
    print(f"gradient relative L2 {rel:.3e}, cosine {cos:.9f}")
    assert rel < grad_rel and cos > 0.9999, (rel, cos)
    for got, want in zip(res["bn"], ref["bn"]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
    p0 = jax.tree.leaves(params0)
    for got, want, g, gp, q in zip(res["params"], ref["params"],
                                   ref["grads"], res["grads"], p0):
        upd = np.abs(np.asarray(got, np.float64) - q)
        assert upd.max() <= LR * (1 + 1e-3)
        sure = np.abs(g) > 2 * np.abs(gp - g).max()
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5,
                                   rtol=1e-3)
    return rel, cos


TRAIN_CASES = {
    "dp2": ("jsd", dict(mode="dp", shape=(2,), names=D)),
    "dp4": ("jsd", dict(mode="dp", shape=(4,), names=D)),
    "dp4_rsn": ("rsn", dict(mode="dp", shape=(4,), names=D, loss="rsn")),
    "dp2_rsn": ("rsn", dict(mode="dp", shape=(2,), names=D, loss="rsn")),
    "spatial_1x2": ("jsd", dict(mode="spatial", shape=(1, 2), names=DS)),
    "spatial_2x2": ("jsd", dict(mode="spatial", shape=(2, 2), names=DS)),
    "spatial_1x2x2": ("jsd", dict(mode="spatial", shape=(1, 2, 2),
                                  names=DSW)),
    "tp_1x2": ("jsd", dict(mode="tp", shape=(1, 2), names=DM)),
    "tp_2x2": ("jsd", dict(mode="tp", shape=(2, 2), names=DM)),
    "pp_1x2_m2": ("mb2", dict(mode="pp", shape=(1, 2), names=DST,
                              microbatches=2)),
    "pp_1x2_m4": ("mb4", dict(mode="pp", shape=(1, 2), names=DST,
                              microbatches=4)),
    "dp2_m2": ("mb2", dict(mode="dp", shape=(2,), names=D,
                           microbatches=2)),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_parallel_step_matches_jax(world, model8, oracles, case):
    ref_key, kw = TRAIN_CASES[case]
    n = int(np.prod(kw["shape"]))
    ranks = list(range(n))
    p, s = model8
    out = world.run("train", ranks=ranks, x=X8, lr=LR, params=p, state=s,
                    **kw)
    _check_train(oracles[ref_key], out, ranks, p)
    assert out[0]["count"] == 1


def test_pp_data_axis_bitexact(world, model8, oracles):
    """The pipeline on (data 2, stage 2), M = 2: loss, BatchNorm state and
    gradient direction against the microbatch mate, and the duplicated-
    shard probe of the JAX package's own test of the same name: with each
    microbatch's frames on both data shards, the data-axis sums are exact
    doublings, so the gradient must equal the (1, 2) pipeline's on the
    single copy bit for bit; a frame mix-up between shards or microbatches,
    a wrong mean scale or a missing BatchNorm reduction shows as a nonzero
    difference. (The gradient's distance to the float64 one is not the
    test here: on these frames the port's data-split step and JAX's own
    float32 step agree to 3.4e-6 and both sit 2.1e-3 from the float64 one,
    where the single-device port sits at 5e-7: a near tie in a pooling or
    ReLU decision that float32 breaks either way.)"""
    p, s = model8
    ref = oracles["mb2"]
    out = world.run("train", mode="pp", shape=(2, 2), names=DST,
                    ranks=[0, 1, 2, 3], x=X8, lr=LR, params=p, state=s,
                    microbatches=2)
    assert len({o["digest"] for o in out}) == 1
    np.testing.assert_allclose(out[0]["loss"], ref["loss"], rtol=1e-5)
    for got, want in zip(out[0]["bn"], ref["bn"]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
    a, b = _vec(ref["grads"]), _vec(out[0]["grads"])
    assert (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.9999
    half = X8[[0, 1, 4, 5]]                  # two microbatches of 2
    dup = X8[[0, 1, 0, 1, 4, 5, 4, 5]]       # each on both data shards
    two = world.run("train", mode="pp", shape=(2, 2), names=DST,
                    ranks=[0, 1, 2, 3], x=dup, lr=LR, params=p, state=s,
                    microbatches=2)
    one = world.run("train", mode="pp", shape=(1, 2), names=DST,
                    ranks=[0, 1], x=half, lr=LR, params=p, state=s,
                    microbatches=2)
    assert two[0]["loss"] == one[0]["loss"]
    for g2, g1 in zip(two[0]["grads"], one[0]["grads"]):
        np.testing.assert_array_equal(g2, g1)


# ---------------------------------------------------------------------------
# pair-packed data parallelism at base 64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wp_case(model64, jax_runs):
    """JAX's float64 step on X_WP at base 64 (the pair-packed geometry)
    and the port's single-device pair-packed float32 gradient."""
    import torch
    from onet_tpu_torch.core.bridge import from_jax_numpy
    from onet_tpu_torch.models import onet as TO
    from onet_tpu_torch.train.steps import make_train_step
    from torch_parallel_worker import leaves_np

    p, s = model64
    old, TO.PAIR_PACK = TO.PAIR_PACK, True
    try:
        _, _, g = make_train_step().loss_and_grads(
            *from_jax_numpy(p, s, device="cpu"), torch.tensor(X_WP))
    finally:
        TO.PAIR_PACK = old
    return p, s, jax_runs["wp"].result(), leaves_np(g)


def test_pair_packed_dp_step_matches_jax(world, wp_case):
    """The data-parallel step (data 2) on the pair-packed path, the
    kernels' plain versions here: BatchNorm statistics from the kernels'
    epilogue sums, all-reduced, and the all-reduced sums of _BnApplyWp's
    backward. Base 64 at 16x16 and batch 4 (2 a rank): the deepest level
    is 1x1 and BatchNorm there normalizes 2 values per branch, so every
    float32 gradient of this net is far from the float64 one (the port's
    single-device pair-packed gradient by 4.8e-3, JAX's float32 one by
    2.5e-3). The data-parallel gradient is held to within 1.5 times the
    single-device one's distance (cosine > 0.9999); with the backward's
    all-reduce removed it is 1.5 away (cosine 0.55), a per-rank
    BatchNorm gradient."""
    p, s, ref, single = wp_case
    base = np.linalg.norm(_vec(ref["grads"]) - _vec(single)) / \
        np.linalg.norm(_vec(ref["grads"]))
    out = world.run("train", mode="dp", shape=(2,), names=D, ranks=[0, 1],
                    x=X_WP, lr=LR, params=p, state=s, pair_pack=True)
    _check_train(ref, out, [0, 1], p, grad_rel=1.5 * base)


# ---------------------------------------------------------------------------
# JAX's own mesh step
# ---------------------------------------------------------------------------

def test_dp_step_matches_jax_mesh_step(world, model8, jax_runs):
    """JAX's GSPMD data-parallel step on the virtual mesh (data 2) and the
    port's over two ranks, from the same weights and frames."""
    p, s = model8
    ref = jax_runs["mesh"].result()
    jl, jb, jp = ref["loss"], ref["bn"], ref["params"]
    out = world.run("train", mode="dp", shape=(2,), names=D, ranks=[0, 1],
                    x=X8, lr=LR, params=p, state=s)
    res = out[0]
    assert out[0]["digest"] == out[1]["digest"]
    np.testing.assert_allclose(res["loss"], jl, rtol=1e-5)
    for got, want in zip(res["bn"], jb):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3)
    # the update directions: JAX's own mesh tests ask > 0.9 of the signs
    # to agree between its mesh and single-device steps; here > 0.99
    u1 = _vec([a - q for a, q in zip(jp, jax.tree.leaves(p))])
    u2 = _vec([a - q for a, q in zip(res["params"], jax.tree.leaves(p))])
    same = float(np.mean(np.sign(u1) == np.sign(u2)))
    assert same > 0.99, same


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align", ["flip", "hungarian"])
def test_eval_step_matches_jax(world, model8, jax_runs, align):
    """The mesh eval step (data 2; spatial 1x2) on the global batch: the
    predictions gathered, metrics on the global batch, equal to JAX's
    single-device eval."""
    p, s = model8
    ref = jax_runs[align].result()
    jm, jl, jpred = ref["metrics"], ref["loss"], ref["pred"]
    labels = LABELS
    for kw in (dict(shape=(2,), names=D),
               dict(shape=(1, 2), names=DS, spatial=True)):
        out = world.run("eval", ranks=[0, 1], x=X8, labels=labels,
                        params=p, state=s, align=align, **kw)
        for r in (0, 1):
            res = out[r]
            np.testing.assert_allclose(res["loss"], float(jl), rtol=1e-5)
            assert (res["pred"] == np.asarray(jpred)).mean() >= 0.999
            for k in jm:
                assert abs(res["metrics"][k] - float(jm[k])) <= 2e-3, k


# ---------------------------------------------------------------------------
# collectives against lax's under shard_map
# ---------------------------------------------------------------------------

def _lax_collective(op, n, x, gs, dim):
    """lax's forward and the gradient of sum(out * g) per device."""
    mesh = j_make_mesh(shape=(n,), devices=jax.devices()[:n],
                       axis_names=("i",))
    perm = [(i, (i + 1) % n) for i in range(n - 1)]
    fns = {
        "psum": lambda v: lax.psum(v, "i"),
        "pmean": lambda v: lax.pmean(v, "i"),
        "ppermute": lambda v: lax.ppermute(v, "i", perm),
        "all_gather": lambda v: lax.all_gather(v, "i", axis=dim,
                                               tiled=True),
        "psum_scatter": lambda v: lax.psum_scatter(
            v, "i", scatter_dimension=dim, tiled=True),
    }
    fn = fns[op]

    def per_dev(v, g):
        y, vjp = jax.vjp(fn, v[0])
        (dx,) = vjp(g[0])
        return y[None], dx[None]

    f = jax.jit(jax.shard_map(per_dev, mesh=mesh,
                              in_specs=(P("i"), P("i")),
                              out_specs=(P("i"), P("i")), check_vma=False))
    y, dx = f(jnp.asarray(x), jnp.asarray(gs))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("op", ["psum", "pmean", "ppermute", "all_gather",
                                "psum_scatter"])
def test_collectives_match_lax(world, op):
    """Forward and backward of each collective on 4 ranks, against lax's
    under shard_map with the same per-device inputs and cotangents."""
    n, dim = 4, 1
    x = np.random.default_rng(0).normal(size=(n, 3, 8, 2)).astype(np.float32)
    out = world.run("collective", shape=(n,), names=D, ranks=list(range(n)),
                    x=x, axis="data", op=op, dim=dim)
    gs = np.stack([o["g"] for o in out])
    y, dx = _lax_collective(op, n, x, gs, dim)
    for r in range(n):
        assert out[r]["index"] == r
        np.testing.assert_allclose(out[r]["y"], y[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[r]["dx"], dx[r], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# halo conv, shape validation, multihost helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(1, 2, 1), (1, 2, 2)])
def test_halo_conv_matches_same_padding(world, grid):
    """The halo conv on a 1-D (rows) and a 2-D (rows x columns) block grid
    equals the JAX package's SAME conv on the whole image, the corners of
    the 2-D grid included."""
    from onet_tpu.models import layers as JL
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 4)).astype(
        np.float32)
    w = np.random.default_rng(1).normal(size=(3, 3, 4, 4)).astype(
        np.float32)
    want = np.asarray(JL.conv3x3(jnp.asarray(x), jnp.asarray(w)))
    _, rows, cols = grid
    names, shape = (DSW, grid) if cols > 1 else (DS, (1, rows))
    n = rows * cols
    out = world.run("halo_conv", shape=shape, names=names,
                    ranks=list(range(n)), x=x, w=w, n_space=rows,
                    n_spacew=cols)
    h, wd = 16 // rows, 16 // cols
    for o in out[:n]:
        i, j = o["coords"]["space"], o["coords"].get("spacew", 0)
        np.testing.assert_allclose(
            o["y"], want[:, i * h:(i + 1) * h, j * wd:(j + 1) * wd],
            atol=1e-5, rtol=1e-5)


def test_validate_spatial_shapes():
    from onet_tpu_torch.parallel.halo import validate_spatial_shapes
    for args, kw in (((64, 2), {}), ((40, 2), {}),
                     ((64, 2), dict(w=32, n_spacew=2)),
                     ((64, 2), dict(w=40, n_spacew=2))):
        try:
            j_validate(*args, **kw)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            validate_spatial_shapes(*args, **kw)
        else:
            with pytest.raises(ValueError) as got:
                validate_spatial_shapes(*args, **kw)
            assert str(got.value) == want


def test_multihost_helpers(world, monkeypatch):
    """process_batch_slice and fold_process_key on each of 4 ranks against
    JAX's functions for the same process index and count; global_batch
    reassembles the global batch from the ranks' blocks."""
    from onet_tpu_torch.core.prng import derive_seed
    out = world.run("multihost", n=8)
    for r, o in enumerate(out):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: 4)
        js = JM.process_batch_slice(8)
        assert o["slice"] == (js.start, js.stop)
        assert (o["index"], o["count"]) == (r, 4)
        # JAX folds its key with the process index; the port its seed
        k = JM.fold_process_key(jax.random.key(1981))
        assert bool(jnp.all(jax.random.key_data(k) == jax.random.key_data(
            jax.random.fold_in(jax.random.key(1981), r))))
        assert o["key"] == derive_seed(1981, r)
        assert o["global_ok"]
    assert len({o["key"] for o in out}) == 4


# ---------------------------------------------------------------------------
# int8 training on a mesh: one activation scale over the global batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_q(model8):
    """The port's one-device int8 step on the global batch XQ, per level:
    the first conv's codes and scale, 3 steps' losses, the first step's
    gradient and the final parameters; and ``moved``, the first step's
    gradient with the first activation scale one ulp up."""
    import torch
    from onet_tpu_torch.models import qtrain as Q
    from onet_tpu_torch.ops.math import div
    from onet_tpu_torch.train import optim, steps as S
    from torch_parallel_worker import leaves_np, tree_t

    real = Q._quant_act

    def run(level, steps, moved=False):
        first, grads = [], []

        def quant(x, axis=None):
            if moved and not first:
                xf = x.float()
                sc = torch.nextafter(torch.clamp_min(
                    div(torch.amax(torch.abs(xf)), Q.QMAX), 1e-12),
                    torch.tensor(np.inf))
                q = torch.clamp(torch.round(xf / sc), -Q.QMAX, Q.QMAX)
                q = q.to(torch.int8)
            else:
                q, sc = real(x, axis)
            if not first:
                first.append((q.numpy().copy(), sc.numpy().copy()))
            return q, sc

        def adam(g, o, lr):
            grads.append(leaves_np(g))
            return optim.adam_update(g, o, lr)

        old = S.adam_update
        Q._quant_act, S.adam_update = quant, adam
        try:
            p, s = (tree_t(t) for t in model8)
            o, losses = optim.adam_init(p), []
            step = S.make_train_step(quantized=level)
            for _ in range(steps):
                p, s, o, v = step(p, s, o, torch.tensor(XQ), LR_Q)
                losses.append(float(v))
        finally:
            Q._quant_act, S.adam_update = real, old
        return dict(codes=first[0][0], sx=first[0][1], losses=losses,
                    grads=grads[0], params=leaves_np(p))

    out = {}
    for level in LEVELS:
        out[level] = run(level, 3)
        out[level]["moved"] = run(level, 1, moved=True)["grads"]
    return out


def _cos(a, b):
    a, b = _vec(a), _vec(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _updates(params, p0):
    return [np.asarray(a, np.float64) - q for a, q in zip(params, p0)]


@pytest.mark.parametrize("level", LEVELS)
def test_int8_dp_step_takes_global_scale(world, model8, port_q, jax_runs,
                                         level):
    """Data parallel (data 2) int8 training on frames whose halves have
    maxima 3x apart. JAX's GSPMD step quantizes the global batch with one
    scale (``_quant_act``'s max runs over the sharded batch); every rank
    must take the same scale: the first conv's codes and scale on each
    rank bit-equal to the one-device port step's on its rows (before the
    fix rank 0 took 1/127 where the global scale is 3/127), the scale
    within 2 ulps of JAX's mesh step's (jitted XLA multiplies by 1/127),
    3 Adam steps' losses within tests/test_torch_qtrain.py's rtol 1e-3 of
    JAX's mesh step. The parameters after them: Adam from zero moments
    moves each by about lr * sign(g) a step, so a gradient near zero can
    flip a step's sign; the mesh step's updates must agree with JAX's mesh
    step's as well as the one-device port step's do (cosine and sign
    share within 0.01 of its)."""
    p, s = model8
    one, ref = port_q[level], jax_runs[f"q_{level}"].result()
    out = world.run("qtrain", shape=(2, 1), names=DS, ranks=[0, 1], x=XQ,
                    lr=LR_Q, params=p, state=s, level=level)
    assert out[0]["digest"] == out[1]["digest"]
    for r in (0, 1):
        np.testing.assert_array_equal(out[r]["sx"], one["sx"])
        np.testing.assert_array_equal(out[r]["codes"],
                                      one["codes"][4 * r:4 * r + 4])
    np.testing.assert_array_max_ulp(out[0]["sx"], ref["sx"], maxulp=2)
    np.testing.assert_allclose(out[0]["losses"], ref["mesh_losses"],
                               rtol=1e-3)
    p0 = jax.tree.leaves(p)
    uj = _vec(_updates(ref["mesh_params"], p0))
    for tag, got in (("mesh", out[0]["params"]), ("one", one["params"])):
        u = _vec(_updates(got, p0))
        cos = float(u @ uj / (np.linalg.norm(u) * np.linalg.norm(uj)))
        same = float(np.mean(np.sign(u) == np.sign(uj)))
        if tag == "mesh":
            mesh_cos, mesh_same = cos, same
    print(f"updates against JAX's mesh step: mesh cosine {mesh_cos:.4f} "
          f"signs {mesh_same:.4f}; one-device {cos:.4f} {same:.4f}")
    assert mesh_cos >= cos - 0.01 and mesh_same >= same - 0.01


@pytest.mark.parametrize("grid,level", [((1, 2), "fwd"),
                                        ((1, 2), "fwd+dx"),
                                        ((1, 2, 2), "fwd")])
def test_int8_spatial_step_matches_one_device(world, model8, port_q,
                                              jax_runs, grid, level):
    """int8 training on the halo step (mesh (1, 2) and (1, 2, 2)): each
    rank quantizes its halo-padded block with the global scale, so its
    first-conv codes are the one-device step's, zero-padded at the image
    edges, and the first loss is within 1e-4 relative of the port's and
    JAX's one-device int8 step's.

    Gradient: int8 training's gradient has a cliff at a rounding boundary.
    The one-device step with its first activation scale one ulp up
    (``moved``) flips codes and reads cosine 0.99924 (fwd) / 0.99915
    (fwd+dx) of the step as it is. The meshes sum BatchNorm's statistics
    in another order (per block, then all-reduced); on these frames that
    lands (1, 2)'s gradient at cosine 0.99923 / 0.99915 of the one-device
    step's and 0.99999 / 0.99997 of the moved one's, and (1, 2, 2)'s the
    other way round. Held: cosine > 0.9999 to the nearer of the two, and
    to JAX's one-device gradient within 1e-4 of that one's. A halo
    backward that drops the exchanged rows' cotangents reads 0.9970 to
    0.9975 on (1, 2) against either."""
    p, s = model8
    one, ref = port_q[level], jax_runs[f"q_{level}"].result()
    names = DSW if len(grid) == 3 else DS
    n = int(np.prod(grid))
    out = world.run("qtrain", shape=grid, names=names, ranks=list(range(n)),
                    x=XQ, lr=LR_Q, params=p, state=s, level=level,
                    spatial=True, steps=1)
    assert len({o["digest"] for o in out[:n]}) == 1
    cols = len(grid) == 3
    padded = np.pad(one["codes"], ((0, 0), (1, 1), (int(cols), int(cols)),
                                   (0, 0)))
    h, w = 32 // grid[1], 32 // (grid[2] if cols else 1)
    for o in out[:n]:
        i, j = o["coords"]["space"], o["coords"].get("spacew", 0)
        want = padded[:, i * h:i * h + h + 2]
        if cols:
            want = want[:, :, j * w:j * w + w + 2]
        np.testing.assert_array_equal(o["sx"], one["sx"])
        np.testing.assert_array_equal(o["codes"], want)
    res = out[0]
    np.testing.assert_allclose(res["losses"][0], one["losses"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(res["losses"][0], ref["loss"], rtol=1e-4)
    c_one, c_moved = (_cos(res["grads"], one[k]) for k in ("grads",
                                                           "moved"))
    near = one["grads"] if c_one >= c_moved else one["moved"]
    got_j, base = _cos(res["grads"], ref["grads"]), _cos(near, ref["grads"])
    print(f"gradient cosine: one-device port {c_one:.6f}, moved "
          f"{c_moved:.6f}; JAX {got_j:.6f} (the nearer to JAX {base:.6f})")
    assert max(c_one, c_moved) > 0.9999 and got_j > base - 1e-4


@pytest.mark.parametrize("grid", [(1, 2, 1), (1, 2, 2)])
def test_halo_int8_conv_matches_one_device(world, grid):
    """The halo int8 conv on each rank's block, with the scale taken over
    the mesh, equals the one-device int8 conv's rows bit for bit (int8
    sums are exact; the conv pads SAME and is cut to the VALID extent)."""
    import torch
    from onet_tpu_torch.models.qtrain import conv3x3_q
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 4)).astype(
        np.float32)
    x[:, 8:] *= 3.0                       # the lower blocks hold the max
    w = np.random.default_rng(1).normal(size=(3, 3, 4, 4)).astype(
        np.float32)
    want = conv3x3_q(torch.tensor(x), torch.tensor(w), torch.float32,
                     False).numpy()
    _, rows, cols = grid
    names, shape = (DSW, grid) if cols > 1 else (DS, (1, rows))
    n = rows * cols
    out = world.run("halo_conv", shape=shape, names=names,
                    ranks=list(range(n)), x=x, w=w, n_space=rows,
                    n_spacew=cols, quantized="fwd")
    h, wd = 16 // rows, 16 // cols
    for o in out[:n]:
        i, j = o["coords"]["space"], o["coords"].get("spacew", 0)
        np.testing.assert_array_equal(
            o["y"], want[:, i * h:(i + 1) * h, j * wd:(j + 1) * wd])


def test_drivers_refuse_spatial_int8():
    """The step runs int8 on the halo path; the simclutter driver still
    refuses ``spatial`` with ``quantized`` before any work, with the JAX
    package's driver's message (the JAX driver refuses after generating
    its data, so its message is read from its source)."""
    import inspect

    from onet_tpu.train import simclutter as JS
    from onet_tpu_torch.train import simclutter as TS

    with pytest.raises(ValueError) as e:
        TS.train(TS.SimclutterConfig(quantized="fwd"), mesh=object(),
                 spatial=True)
    assert str(e.value) == "spatial training is exact-arithmetic only"
    assert f'raise ValueError("{e.value}")' in inspect.getsource(JS.train)
