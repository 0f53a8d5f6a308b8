"""Device mesh over ``torch.distributed`` (``onet_tpu/core/mesh.py``).

The JAX package is single-controller: one process sees a mesh of devices
and ``shard_map`` / GSPMD place the collectives. The port is
multi-controller: one process per device, each holding its own shard and
calling the collectives itself (``parallel/collectives.py``). A ``Mesh``
is one process's view of a logical grid of the world's ranks, row-major
over its axes: the axis names and sizes, this rank's coordinates, and one
process group for every set of axes a step may reduce over, created once
here because ``torch.distributed.new_group`` is collective over the whole
world.

Axis names as in the JAX package: ``data`` (batch), ``space`` (image
rows), ``spacew`` (image columns), ``model`` (conv channels) and
``stage`` (network depth). A mesh of one rank needs no process group and
works without ``torch.distributed``.

``replicated``, ``batch_sharding`` and ``put_per_spec`` keep JAX's names:
a sharding here is the rule that cuts this rank's block out of a global
tensor (``Sharding.local``), and the replicated one keeps the tensor
whole. The train and eval steps take the global batch, as JAX's do, and
cut their blocks themselves.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"      # image height (rows)
SPACEW_AXIS = "spacew"    # image width (columns): 2-D spatial partitioning
MODEL_AXIS = "model"      # conv channels (parallel/tensor.py)
STAGE_AXIS = "stage"      # network depth (parallel/pipeline.py)


class Axis:
    """A set of mesh axes seen from this rank: the ``size`` ranks that
    share this rank's coordinates on every other axis, in row-major order
    over the named axes (``ranks``, global ranks), this rank's position
    among them (``index``) and their process group (None for one rank).
    ``names`` holds the axes of more than one rank, ``wanted`` every axis
    asked for (what a collective over it spans on a larger mesh)."""

    def __init__(self, names, ranks, index, group, wanted):
        self.names = tuple(names)
        self.wanted = tuple(wanted)
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group

    def global_rank(self, i: int) -> int:
        """The global rank at position ``i`` of this axis."""
        return self.ranks[i]

    def __repr__(self):
        return (f"Axis({self.names}, size={self.size}, index={self.index}, "
                f"ranks={self.ranks})")


class Mesh:
    """This rank's view of a row-major grid of ``ranks`` (default: the
    whole world) with ``axis_names``. ``shape`` maps name -> size, as
    JAX's ``Mesh.shape``; ``coords`` maps name -> this rank's index."""

    def __init__(self, shape, axis_names, ranks, rank, groups):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = rank
        pos = self.ranks.index(rank)
        coords = []
        for s in reversed(tuple(self.shape.values())):
            coords.append(pos % s)
            pos //= s
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        self._groups = groups

    def axis(self, names) -> Axis:
        """The Axis over ``names`` (one name or several; names absent from
        the mesh count as size 1)."""
        if isinstance(names, str):
            names = (names,)
        live = tuple(n for n in self.axis_names
                     if n in names and self.shape[n] > 1)
        ranks = _sub_ranks(self, live)
        group = self._groups.get(live)
        return Axis(live, ranks, ranks.index(self.rank), group,
                    wanted=tuple(names))

    @property
    def world(self) -> Axis:
        """Every axis: the group the gradients reduce over. A mesh of one
        rank in an initialized world of one still gets that world's group,
        so its reductions run through the backend."""
        ax = self.axis(self.axis_names)
        if ax.group is None and dist.is_initialized() and \
                dist.get_world_size() == 1:
            ax.group = dist.group.WORLD
        return ax

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords})")


def _grid(mesh_shape, ranks):
    """{coords tuple: global rank} of a row-major grid."""
    return {c: ranks[i] for i, c in enumerate(
        itertools.product(*(range(s) for s in mesh_shape)))}


def _sub_ranks(mesh: Mesh, live) -> list:
    """The ranks that vary over the axes ``live`` with this rank's other
    coordinates fixed, row-major over ``live``."""
    names = mesh.axis_names
    grid = _grid(tuple(mesh.shape.values()), mesh.ranks)
    out = []
    for sub in itertools.product(*(range(mesh.shape[n]) for n in live)):
        c = dict(mesh.coords)
        c.update(zip(live, sub))
        out.append(grid[tuple(c[n] for n in names)])
    return out


def make_mesh(shape=None, axis_names=(DATA_AXIS, SPACE_AXIS), *,
              ranks=None):
    """Build this rank's Mesh over ``ranks`` (default: every rank of the
    initialized world; one rank without ``torch.distributed``). Default
    shape: every rank on the first axis. Every rank of the world must
    call it, in the same order as the others (process groups are created
    collectively); a rank outside ``ranks`` gets None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{tuple(axis_names)}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if n > 1 and not dist.is_initialized():
        raise ValueError(f"a mesh of {n} ranks needs torch.distributed "
                         "(parallel/multihost.py::initialize)")
    grid = _grid(shape, ranks)
    names = tuple(axis_names)
    live_all = tuple(a for a, s in zip(names, shape) if s > 1)
    groups = {}
    for k in range(1, len(live_all) + 1):
        for live in itertools.combinations(live_all, k):
            fixed = [a for a in names if a not in live]
            for other in itertools.product(
                    *(range(shape[names.index(a)]) for a in fixed)):
                members = []
                for sub in itertools.product(
                        *(range(shape[names.index(a)]) for a in live)):
                    c = dict(zip(fixed, other))
                    c.update(zip(live, sub))
                    members.append(grid[tuple(c[a] for a in names)])
                g = dist.new_group(members)
                if rank in members:
                    groups[live] = g
    if rank not in ranks:
        return None
    return Mesh(shape, names, ranks, rank, groups)


class Sharding:
    """Which tensor dims split over which mesh axes: ``local(t)`` is this
    rank's block of the global tensor ``t`` (equal blocks; a dim that does
    not divide raises ValueError)."""

    def __init__(self, mesh: Mesh, dims: dict):
        self.mesh = mesh
        self.dims = dict(dims)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        for d, name in self.dims.items():
            n = self.mesh.shape.get(name, 1)
            if n == 1:
                continue
            size = t.shape[d]
            if size % n:
                raise ValueError(f"dim {d} of size {size} does not split "
                                 f"over {n} '{name}' shards")
            k = size // n
            t = t.narrow(d, self.mesh.coords[name] * k, k)
        return t


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, {})


def batch_sharding(mesh: Mesh, *, spatial: bool = False,
                   rank: int = 4) -> Sharding:
    """[N, H, W, C] (or [N, H, W] with ``rank=3``): N over ``data``; with
    ``spatial``, H over ``space`` and W over ``spacew`` where the mesh has
    them."""
    dims = {0: DATA_AXIS}
    if spatial:
        dims[1] = SPACE_AXIS
        if rank >= 3:
            dims[2] = SPACEW_AXIS
    return Sharding(mesh, {d: a for d, a in dims.items()
                           if a in mesh.axis_names})


def put_per_spec(tree, sharding: Sharding):
    """This rank's block of every leaf of ``tree``."""
    from onet_tpu_torch.models.unet import tree_map
    return tree_map(sharding.local, tree)
