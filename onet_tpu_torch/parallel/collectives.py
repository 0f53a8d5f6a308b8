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
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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

def all_reduce_(t: torch.Tensor, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous ``t`` over ``axis`` (a no-op
    without an axis or a group)."""
    if axis is None or axis.group is None:
        return t
    return _run(axis, t, lambda u: dist.all_reduce(u, op=op,
                                                   group=axis.group))


def broadcast_(t: torch.Tensor, axis, src_index: int) -> torch.Tensor:
    """In-place broadcast of a contiguous ``t`` from position
    ``src_index`` of ``axis``."""
    if axis.group is None:
        return t
    src = axis.global_rank(src_index)
    return _run(axis, t, lambda u: dist.broadcast(u, src=src,
                                                  group=axis.group))


def gather_parts(t: torch.Tensor, axis) -> list:
    """Every rank's ``t`` (equal shapes), in axis order."""
    if axis.group is None:
        return [t]
    src = t.detach().contiguous()
    host = _host(axis, src)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return [p.to(t.device) for p in parts] if host else parts


def _reduce_scatter(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    t = t.contiguous()
    k = t.shape[dim] // axis.size
    if dist.get_backend(axis.group) == "nccl":
        chunks = [c.contiguous() for c in t.split(k, dim=dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=axis.group)
        return out
    full = all_reduce_(t.clone(), axis)
    return full.narrow(dim, axis.index * k, k).contiguous()


def _all_gather(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    return torch.cat(gather_parts(t, axis), dim=dim)


def _permute(t: torch.Tensor, axis, perm) -> torch.Tensor:
    """Send ``t`` to the destinations of ``perm`` ((src, dst) positions on
    ``axis``); the result holds what this rank received, zeros if no one
    sends to it."""
    me = axis.index
    t = t.detach().contiguous()
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
    def forward(ctx, x, axis, scale):
        ctx.axis, ctx.scale = axis, scale
        y = all_reduce_(x.detach().clone().contiguous(), axis)
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        y = all_reduce_(g.clone().contiguous(), ctx.axis)
        return (y * ctx.scale if ctx.scale != 1 else y), None, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over ``axis``, replicated on every rank of it."""
    if axis.group is None:
        return x
    return _Psum.apply(x, axis, 1.0)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """Mean over ``axis`` (equal shards), replicated."""
    if axis.group is None:
        return x
    return _Psum.apply(x, axis, 1.0 / axis.size)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.axis, inv), None, None


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is a list of (source, destination)
    positions on ``axis``; a rank that receives nothing gets zeros."""
    if axis.group is None:
        pairs = [(s, d) for s, d in perm if s == d == 0]
        return x if pairs else torch.zeros_like(x)
    return _Ppermute.apply(x, axis, tuple(perm))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Concatenation of every rank's ``x`` along ``dim`` (JAX's
    ``all_gather(..., tiled=True)``)."""
    if axis.group is None:
        return x
    return _AllGather.apply(x, axis, dim % x.dim())


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_scatter(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.axis, ctx.dim), None, None


def psum_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The sum over ``axis``, of which each rank keeps its block along
    ``dim`` (JAX's ``psum_scatter(..., tiled=True)``)."""
    if axis.group is None:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {axis.size} ranks")
    return _PsumScatter.apply(x, axis, dim % x.dim())


def all_reduce_flat(tensors, axis, scale: float = 1.0) -> list:
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
        all_reduce_(flat, axis)
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out
