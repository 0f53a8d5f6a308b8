"""Worker side of the port's parallel tests (tests/test_torch_parallel*.py).

``World`` spawns a gloo world of N CPU processes once and runs every case
in it: the test process sends a case name and numpy arguments to every
rank, each rank runs the case on its block of the work and sends numpy
results back. Rank 0 returns the arrays; every rank returns a digest of
its parameters, optimizer state and BatchNorm state, so the test can check
that the ranks hold bit-equal trees. A rank outside a case's mesh returns
None. This module imports torch and the port only, never JAX: the spawned
processes import it.
"""

from __future__ import annotations

import hashlib
import os
import queue
import traceback

import numpy as np
import torch

TIMEOUT = 240


# ---------------------------------------------------------------------------
# the test process's side
# ---------------------------------------------------------------------------

class World:
    """N spawned ranks; ``run(case, **kw)`` -> [result of rank 0..N-1]."""

    def __init__(self, n: int, tmpdir: str):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = n
        self.inq = [ctx.Queue() for _ in range(n)]
        self.outq = ctx.Queue()
        path = os.path.join(tmpdir, "rendezvous")
        self.procs = [ctx.Process(target=serve,
                                  args=(r, n, path, self.inq[r], self.outq),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, case: str, **kw):
        for q in self.inq:
            q.put((case, kw))
        out = [None] * self.n
        for _ in range(self.n):
            try:
                rank, res = self.outq.get(timeout=TIMEOUT)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"case {case}: a rank did not answer in "
                                   f"{TIMEOUT} s")
            if isinstance(res, str) and res.startswith("Traceback"):
                raise RuntimeError(f"rank {rank} failed in {case}:\n{res}")
            out[rank] = res
        return out

    def close(self):
        for q in self.inq:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def serve(rank, world, path, inq, outq):
    torch.set_num_threads(1)
    from onet_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{path}", world, rank, device="cpu")
    while True:
        job = inq.get()
        if job is None:
            break
        case, kw = job
        try:
            res = CASES[case](**kw)
        except Exception:
            res = traceback.format_exc()
        outq.put((rank, res))


def tree_t(tree):
    """Numpy tree -> torch tree (copies)."""
    from onet_tpu_torch.models.unet import tree_map
    return tree_map(lambda a: torch.tensor(np.array(a)), tree)


def leaves_np(tree):
    from onet_tpu_torch.models.unet import tree_leaves
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


def digest(*trees) -> str:
    from onet_tpu_torch.models.unet import tree_leaves
    h = hashlib.sha256()
    for tree in trees:
        for t in tree_leaves(tree):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _mesh(shape, names, ranks):
    from onet_tpu_torch.core.mesh import make_mesh
    return make_mesh(tuple(shape), tuple(names), ranks=ranks)


def _model(params, state, base, seed):
    from onet_tpu_torch.models.onet import onet_init
    if params is not None:
        return tree_t(params), tree_t(state)
    return onet_init(torch.Generator().manual_seed(seed), 1, base=base,
                     device="cpu")


def _step(mode, mesh, policy, microbatches, loss, bias=0.0):
    from onet_tpu_torch.train.steps import make_train_step
    if mode == "dp":
        return make_train_step(mesh=mesh, policy=policy, loss=loss,
                               microbatches=microbatches, bias=bias)
    if mode == "spatial":
        return make_train_step(mesh=mesh, spatial=True, policy=policy,
                               loss=loss, microbatches=microbatches,
                               bias=bias)
    if mode == "tp":
        from onet_tpu_torch.parallel.tensor import make_tp_train_step
        return make_tp_train_step(mesh, policy=policy, bias=bias)
    if mode == "pp":
        from onet_tpu_torch.parallel.pipeline import make_pp_train_step
        return make_pp_train_step(mesh, microbatches=microbatches,
                                  policy=policy, bias=bias)
    raise ValueError(mode)


def train_case(mode, shape, names, ranks, x, lr, params=None, state=None,
               base=8, seed=0, loss="jsd", microbatches=1,
               pair_pack=False):
    """One parallel train step on the global batch ``x``; the gradient it
    hands to Adam is caught on the way (``adam_update`` wrapped). Rank 0
    returns loss, grads, params, bn (leaf lists); every rank its
    digest."""
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.models import onet as O
    from onet_tpu_torch.train import optim, steps
    from onet_tpu_torch.train.optim import adam_init

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    p, s = _model(params, state, base, seed)
    caught = []

    def adam(grads, opt_state, lr_):
        caught.append(leaves_np(grads))
        return optim.adam_update(grads, opt_state, lr_)

    old = O.PAIR_PACK, steps.adam_update
    O.PAIR_PACK, steps.adam_update = pair_pack, adam
    try:
        step = _step(mode, mesh, DEFAULT, microbatches, loss)
        p, s, o, v = step(p, s, adam_init(p), torch.tensor(np.array(x)), lr)
    finally:
        O.PAIR_PACK, steps.adam_update = old
    res = {"digest": digest(p, s, o), "rank": mesh.rank}
    if mesh.rank == ranks[0]:
        res.update(loss=float(v), grads=caught[0], params=leaves_np(p),
                   bn=leaves_np(s), count=int(o["count"]))
    return res


def eval_case(shape, names, ranks, x, labels, params, state, spatial=False,
              align="flip", loss="jsd"):
    from onet_tpu_torch.train.steps import make_eval_step

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    step = make_eval_step(mesh=mesh, spatial=spatial, align=align,
                          loss=loss)
    m, v, pred = step(tree_t(params), tree_t(state),
                      torch.tensor(np.array(x)),
                      torch.tensor(np.array(labels)))
    return {"metrics": {k: float(t) for k, t in m.items()},
            "loss": float(v), "pred": pred.numpy()}


def collective_case(shape, names, ranks, x, axis, op, dim=0, seed=0):
    """A collective's forward and the gradient of sum(out * g) for a fixed
    cotangent g on each rank (rank-dependent input blocks of ``x``)."""
    from onet_tpu_torch.parallel import collectives as C

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    ax = mesh.axis(axis)
    xt = torch.tensor(np.array(x[ax.index])).requires_grad_(True)
    if op == "psum":
        y = C.psum(xt, ax)
    elif op == "pmean":
        y = C.pmean(xt, ax)
    elif op == "ppermute":
        n = ax.size
        y = C.ppermute(xt, ax, [(i, (i + 1) % n) for i in range(n - 1)])
    elif op == "all_gather":
        y = C.all_gather(xt, ax, dim)
    elif op == "psum_scatter":
        y = C.psum_scatter(xt, ax, dim)
    else:
        raise ValueError(op)
    g = torch.tensor(np.random.default_rng(seed + ax.index)
                     .normal(size=tuple(y.shape)).astype(np.float32))
    (dx,) = torch.autograd.grad((y * g).sum(), xt)
    return {"index": ax.index, "y": y.detach().numpy(), "g": g.numpy(),
            "dx": dx.numpy()}


def halo_conv_case(shape, names, ranks, x, w, n_space, n_spacew,
                   quantized=None):
    """The halo conv (``quantized``: int8, its scale over the mesh) on
    this rank's block of ``x``; returns (coords, block)."""
    from onet_tpu_torch.core.mesh import DATA_AXIS, SPACE_AXIS, SPACEW_AXIS
    from onet_tpu_torch.core.mesh import batch_sharding
    from onet_tpu_torch.models import layers as L
    from onet_tpu_torch.parallel.halo import make_halo_ops

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    ops = make_halo_ops(n_space, n_spacew, mesh=mesh, quantized=quantized)
    xl = batch_sharding(mesh, spatial=True).local(torch.tensor(x))
    with L.bn_axis(mesh.axis((DATA_AXIS, SPACE_AXIS, SPACEW_AXIS))):
        y = ops.conv3x3(xl, torch.tensor(w))
    return {"coords": mesh.coords, "y": y.numpy()}


def multihost_case(n):
    """The bootstrap helpers on every rank of the world."""
    from onet_tpu_torch.core.mesh import (batch_sharding, make_mesh,
                                          put_per_spec, replicated)
    from onet_tpu_torch.parallel import multihost

    sl = multihost.process_batch_slice(n)
    mesh = make_mesh((2, 2), ("data", "space"))
    glob = torch.arange(4 * 8 * 4 * 1, dtype=torch.float32).reshape(
        4, 8, 4, 1)
    local = batch_sharding(mesh, spatial=True).local(glob)
    back = multihost.global_batch(mesh, local, spatial=True)
    rows = put_per_spec({"x": glob}, batch_sharding(mesh))["x"]
    back_rows = multihost.global_batch(mesh, rows)
    assert replicated(mesh).local(glob) is glob
    assert torch.equal(rows, glob[2 * mesh.coords["data"]:][:2])
    return {"slice": (sl.start, sl.stop),
            "key": multihost.fold_process_key(1981),
            "index": multihost.process_index(),
            "count": multihost.process_count(),
            "global_ok": bool(torch.equal(back, glob)
                              and torch.equal(back_rows, glob))}


def _datasets(data):
    from onet_tpu_torch.data.arrays import ArrayDataset
    return tuple(ArrayDataset({k: torch.tensor(np.array(v))
                               for k, v in d.items()}) for d in data)


def _patched_init(params, state):
    """The port's onet_init, made to return the given weights (the test
    feeds the same ones to the JAX driver)."""
    from onet_tpu_torch.models import onet as O

    def init(gen, in_channels=1, *, device=None, **kw):
        return tree_t(params), tree_t(state)

    old = O.onet_init
    O.onet_init = init
    return lambda: setattr(O, "onet_init", old)


def sim_case(shape, names, ranks, data, cfg, params, state,
             pipeline_microbatches=None, spatial=False, term_rank=None):
    """The simclutter driver on a mesh (every rank runs it). ``term_rank``
    sends itself SIGTERM after epoch 0's eval. Returns each rank's
    history and digest, and what is in out_root."""
    import signal
    from onet_tpu_torch.train import simclutter as S

    mesh = _mesh(shape, names, ranks) if shape else None
    if shape and mesh is None:
        return None
    restore = _patched_init(params, state)
    me = 0 if mesh is None else mesh.rank

    def cb(epoch, loss, metrics):
        if epoch == 0 and me == term_rank:
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        p, s, hist = S.train(S.SimclutterConfig(**cfg), mesh=mesh,
                             pipeline_microbatches=pipeline_microbatches,
                             spatial=spatial, datasets=_datasets(data),
                             log=False, progress_cb=cb, device="cpu")
    finally:
        restore()
    if mesh is not None and mesh.world.group is not None:
        import torch.distributed as dist
        dist.barrier(group=mesh.world.group)
    return {"hist": hist, "digest": digest(p, s),
            "files": sorted(os.listdir(cfg["out_root"]))}


def zy3_case(shape, names, ranks, data, cfg, params, state):
    """The ZY-3 driver on a mesh (every rank runs it)."""
    from onet_tpu_torch.train import zy3 as Z

    mesh = _mesh(shape, names, ranks) if shape else None
    if shape and mesh is None:
        return None
    restore = _patched_init(params, state)
    try:
        p, s, hist = Z.train(Z.Zy3Config(**cfg), *_datasets(data),
                             mesh=mesh, log=False, device="cpu")
    finally:
        restore()
    return {"hist": hist, "digest": digest(p, s)}


def supervised_case(shape, names, ranks, x, labels, params, state, lr):
    """One supervised ZY-3 step on the global batch."""
    from onet_tpu_torch.train.optim import adam_init
    from onet_tpu_torch.train.zy3 import make_supervised_train_step

    mesh = _mesh(shape, names, ranks) if shape else None
    if shape and mesh is None:
        return None
    p, s = tree_t(params), tree_t(state)
    p, s, o, v = make_supervised_train_step(mesh=mesh)(
        p, s, adam_init(p), torch.tensor(x), torch.tensor(labels), lr)
    return {"loss": float(v), "params": leaves_np(p), "bn": leaves_np(s),
            "digest": digest(p, s, o)}


def preempt_case(shape, names, ranks, term_rank, polls=4):
    """The drivers' SIGTERM agreement: ``term_rank`` signals itself after
    the first poll; every rank returns what each poll answered, then the
    settled flag."""
    import signal
    from onet_tpu_torch.train.preempt import PreemptGuard

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    guard = PreemptGuard().install()
    try:
        seen = []
        for i in range(polls):
            seen.append(guard.triggered_on_any(mesh.world, "cpu"))
            if i == 0 and mesh.rank == term_rank:
                os.kill(os.getpid(), signal.SIGTERM)
        seen.append(guard.settled_on_any(mesh.world))
    finally:
        guard.restore()
    return seen


def qtrain_case(shape, names, ranks, x, lr, params, state, level,
                spatial=False, steps=3):
    """``steps`` int8 train steps (``make_train_step(mesh,
    quantized=level)``, with ``spatial`` the halo step) on the global
    batch ``x``. The first activation quantization of the first step (the
    first conv's codes and scale, on this rank's block) is caught on every
    rank, and the first step's gradient on the way to Adam. Rank 0 also
    returns the losses and the final parameters; every rank its digest."""
    from onet_tpu_torch.models import qtrain as Q
    from onet_tpu_torch.train import optim, steps as S
    from onet_tpu_torch.train.optim import adam_init

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    p, s = _model(params, state, 8, 0)
    first, grads = [], []
    real_quant = Q._quant_act

    def quant(*a, **k):
        q, sc = real_quant(*a, **k)
        if not first:
            first.append((q.numpy().copy(), sc.numpy().copy()))
        return q, sc

    def adam(g, opt_state, lr_):
        grads.append(leaves_np(g))
        return optim.adam_update(g, opt_state, lr_)

    old = S.adam_update
    Q._quant_act, S.adam_update = quant, adam
    try:
        step = S.make_train_step(mesh=mesh, spatial=spatial,
                                 quantized=level)
        o, losses = adam_init(p), []
        for _ in range(steps):
            p, s, o, v = step(p, s, o, torch.tensor(np.array(x)), lr)
            losses.append(float(v))
    finally:
        Q._quant_act, S.adam_update = real_quant, old
    res = {"digest": digest(p, s, o), "coords": mesh.coords,
           "codes": first[0][0], "sx": first[0][1]}
    if mesh.rank == ranks[0]:
        res.update(losses=losses, grads=grads[0], params=leaves_np(p))
    return res


def cli_case(argv, driver):
    """``run.main(argv)`` on this rank of the world (a --dp / --pp / --sp
    command runs its rank here, as the ranks ``parallel/launch.py``
    spawns do); the driver's history is caught on the way out. Figures
    are off."""
    import importlib

    from onet_tpu_torch import report, run

    mod = importlib.import_module(f"onet_tpu_torch.train.{driver}")
    real, draw = mod.train, (report.can_draw, mod.can_draw)
    caught = []

    def train(*a, **k):
        out = real(*a, **k)
        caught.append(out[2])
        return out

    mod.train = train
    report.can_draw = mod.can_draw = lambda: False
    try:
        run.main(argv)
    finally:
        mod.train = real
        report.can_draw, mod.can_draw = draw
    return {"hist": caught[0]}


def record_case(what, shape, names, ranks, x=None, microbatches=1,
                argv=None):
    """The collectives one operation issues on this rank
    (``collectives.record``): ``psum`` of ``x``'s block, the forward and
    its gradient; one data-parallel (``dp``) or pipeline (``pp``) train
    step on the global batch ``x``; or the command ``argv``
    (``run.main``)."""
    from onet_tpu_torch.core.policy import DEFAULT
    from onet_tpu_torch.parallel import collectives as C
    from onet_tpu_torch.train.optim import adam_init

    mesh = _mesh(shape, names, ranks)
    if mesh is None:
        return None
    with C.record() as cols:
        if what == "psum":
            xt = torch.tensor(np.array(x[mesh.rank])).requires_grad_(True)
            C.psum(xt, mesh.axis("data")).sum().backward()
        elif what == "command":
            from onet_tpu_torch import run
            run.main(argv)
        else:
            p, s = _model(None, None, 8, 0)
            step = _step(what, mesh, DEFAULT, microbatches, "jsd")
            step(p, s, adam_init(p), torch.tensor(np.array(x)), 1e-4)
    return cols


def failing_rank(kind):
    """A rank for ``parallel/launch.py``'s failure paths: rank 1 refuses
    with ``SystemExit`` (``kind`` "refusal") or raises ("error"); rank 0
    returns and waits for it at the world's last barrier."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        if kind == "refusal":
            raise SystemExit("batch 5 must divide --dp 2")
        raise ValueError("rank 1 broke")
    return "rank 0"


CASES = {"sim": sim_case, "preempt": preempt_case, "zy3": zy3_case, "supervised": supervised_case,
         "train": train_case, "eval": eval_case,
         "collective": collective_case, "halo_conv": halo_conv_case,
         "multihost": multihost_case, "qtrain": qtrain_case,
         "cli": cli_case, "record": record_case}
