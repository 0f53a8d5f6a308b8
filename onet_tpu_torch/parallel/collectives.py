"""The port's counterparts of the ``lax`` collectives the JAX package's
parallel paths use, over a mesh axis (``core/mesh.py::Axis``).

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is the collective's transpose, as JAX's:

  psum          all-reduce SUM          | all-reduce SUM
  pmean         mean                    | mean
  ppermute      send along a permutation; a rank no one sends to gets
                zeros (the halo's SAME padding) | the reverse permutation
  all_gather    all-gather along a dim  | reduce-scatter
  psum_scatter  reduce-scatter          | all-gather

The transposes hold under one convention for what every rank's backward
computes: the gradient of the SUM over ranks of each rank's objective.
Every rank must call the same collectives in the same order, forward and
backward; the steps build the same graph on every rank, so autograd
replays the backward collectives in one order everywhere.

The plain operations below them (``all_reduce_``, ``broadcast_``,
``gather_parts``) are not differentiated; the BatchNorm statistics, the
gradient all-reduce and the state assembly use them.

Backends: NCCL takes CUDA tensors and is used as it is. Gloo takes CPU
tensors for all of these; on CUDA tensors PyTorch's gloo offers only
all-reduce and broadcast. So for a gloo group every operation here copies
a CUDA operand to the host, runs there and copies the result back: one
uniform rule, used where several processes share one card (the chip
smoke's worlds) and never for NCCL. Gloo has no reduce-scatter of its own
either: ``psum_scatter`` on gloo all-reduces and keeps its block.

``record()`` notes each collective as it runs (``utils/projection.py``'s
``Collective``: kind, payload bytes, group size, a name, the mesh axes
and the payload's dtype), whatever the backend does underneath: one note
per execution, so a collective inside the pipeline's microbatch loop is
noted once a trip. ``name`` says what the payload carries (the callers
name gradients ``grads``, BatchNorm sums ``bn_sums``, the int8 scales'
max ``quant_max``); a backward's collective takes its forward's name and
``.grad``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_RECORDERS = []     # lists that record() hands out (autograd's threads too)


@contextlib.contextmanager
def record():
    """Collect every collective issued inside the block into the list it
    yields, in the order they run."""
    out = []
    _RECORDERS.append(out)
    try:
        yield out
    finally:
        _RECORDERS.remove(out)


def _note(kind: str, t: torch.Tensor, axis, name: str) -> None:
    if not _RECORDERS or axis is None or axis.group is None:
        return
    from onet_tpu_torch.utils.projection import Collective
    c = Collective(kind, t.numel() * t.element_size(), axis.size, name,
                   axes=axis.wanted, elem_bytes=t.element_size())
    for rec in _RECORDERS:
        rec.append(c)


def _host(axis, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def _run(axis, t: torch.Tensor, fn) -> torch.Tensor:
    """``fn(tensor)`` in place on ``t`` where the backend takes it, else on
    a host copy written back."""
    if _host(axis, t):
        h = t.cpu()
        fn(h)
        t.copy_(h)
    else:
        fn(t)
    return t


# ---------------------------------------------------------------------------
# plain (not differentiated)
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, axis, op=dist.ReduceOp.SUM,
                name: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of a contiguous ``t`` over ``axis`` (a no-op
    without an axis or a group)."""
    if axis is None or axis.group is None:
        return t
    _note("all-reduce", t, axis, name)
    return _run(axis, t, lambda u: dist.all_reduce(u, op=op,
                                                   group=axis.group))


def broadcast_(t: torch.Tensor, axis, src_index: int,
               name: str = "broadcast") -> torch.Tensor:
    """In-place broadcast of a contiguous ``t`` from position
    ``src_index`` of ``axis``."""
    if axis.group is None:
        return t
    _note("broadcast", t, axis, name)
    src = axis.global_rank(src_index)
    return _run(axis, t, lambda u: dist.broadcast(u, src=src,
                                                  group=axis.group))


def gather_parts(t: torch.Tensor, axis, name: str = "gather") -> list:
    """Every rank's ``t`` (equal shapes), in axis order."""
    if axis.group is None:
        return [t]
    src = t.detach().contiguous()
    _note("all-gather", src.expand(axis.size, *src.shape), axis, name)
    host = _host(axis, src)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return [p.to(t.device) for p in parts] if host else parts


def _reduce_scatter(t: torch.Tensor, axis, dim: int,
                    name: str) -> torch.Tensor:
    t = t.contiguous()
    k = t.shape[dim] // axis.size
    _note("reduce-scatter", t.narrow(dim, 0, k), axis, name)
    if dist.get_backend(axis.group) == "nccl":
        chunks = [c.contiguous() for c in t.split(k, dim=dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=axis.group)
        return out
    full = t.clone()
    _run(axis, full, lambda u: dist.all_reduce(u, group=axis.group))
    return full.narrow(dim, axis.index * k, k).contiguous()


def _all_gather(t: torch.Tensor, axis, dim: int, name: str) -> torch.Tensor:
    return torch.cat(gather_parts(t, axis, name), dim=dim)


def _permute(t: torch.Tensor, axis, perm, name: str) -> torch.Tensor:
    """Send ``t`` to the destinations of ``perm`` ((src, dst) positions on
    ``axis``); the result holds what this rank received, zeros if no one
    sends to it."""
    me = axis.index
    t = t.detach().contiguous()
    _note("collective-permute", t, axis, name)
    host = _host(axis, t)
    buf = t.cpu() if host else t
    out = torch.zeros_like(buf)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, buf, axis.global_rank(dst),
                                  group=axis.group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, axis.global_rank(src),
                                  group=axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(t.device) if host else out


# ---------------------------------------------------------------------------
# differentiable
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, scale, name):
        ctx.axis, ctx.scale, ctx.name = axis, scale, name
        y = all_reduce_(x.detach().clone().contiguous(), axis, name=name)
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        y = all_reduce_(g.clone().contiguous(), ctx.axis,
                        name=ctx.name + ".grad")
        return (y * ctx.scale if ctx.scale != 1 else y), None, None, None


def psum(x: torch.Tensor, axis, name: str = "psum") -> torch.Tensor:
    """Sum over ``axis``, replicated on every rank of it."""
    if axis.group is None:
        return x
    return _Psum.apply(x, axis, 1.0, name)


def pmean(x: torch.Tensor, axis, name: str = "pmean") -> torch.Tensor:
    """Mean over ``axis`` (equal shards), replicated."""
    if axis.group is None:
        return x
    return _Psum.apply(x, axis, 1.0 / axis.size, name)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, name):
        ctx.axis, ctx.perm, ctx.name = axis, perm, name
        return _permute(x, axis, perm, name)

    @staticmethod
    def backward(ctx, g):
        inv = [(dst, src) for src, dst in ctx.perm]
        return (_permute(g, ctx.axis, inv, ctx.name + ".grad"), None, None,
                None)


def ppermute(x: torch.Tensor, axis, perm,
             name: str = "ppermute") -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is a list of (source, destination)
    positions on ``axis``; a rank that receives nothing gets zeros."""
    if axis.group is None:
        pairs = [(s, d) for s, d in perm if s == d == 0]
        return x if pairs else torch.zeros_like(x)
    return _Ppermute.apply(x, axis, tuple(perm), name)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, name):
        ctx.axis, ctx.dim, ctx.name = axis, dim, name
        return _all_gather(x, axis, dim, name)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.axis, ctx.dim, ctx.name + ".grad"),
                None, None, None)


def all_gather(x: torch.Tensor, axis, dim: int,
               name: str = "all_gather") -> torch.Tensor:
    """Concatenation of every rank's ``x`` along ``dim`` (JAX's
    ``all_gather(..., tiled=True)``)."""
    if axis.group is None:
        return x
    return _AllGather.apply(x, axis, dim % x.dim(), name)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, name):
        ctx.axis, ctx.dim, ctx.name = axis, dim, name
        return _reduce_scatter(x.detach(), axis, dim, name)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.contiguous(), ctx.axis, ctx.dim,
                            ctx.name + ".grad"), None, None, None)


def psum_scatter(x: torch.Tensor, axis, dim: int,
                 name: str = "psum_scatter") -> torch.Tensor:
    """The sum over ``axis``, of which each rank keeps its block along
    ``dim`` (JAX's ``psum_scatter(..., tiled=True)``)."""
    if axis.group is None:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {axis.size} ranks")
    return _PsumScatter.apply(x, axis, dim % x.dim(), name)


def all_reduce_flat(tensors, axis, scale: float = 1.0,
                    name: str = "all_reduce_flat") -> list:
    """All-reduce SUM a list of tensors as one flat buffer per dtype (one
    collective per dtype, not one per tensor), times ``scale``; returns
    new tensors in the input order."""
    if (axis is None or axis.group is None) and scale == 1.0:
        return list(tensors)
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce_(flat, axis, name=name)
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out
