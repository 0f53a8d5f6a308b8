"""Multi-process bootstrap (``onet_tpu/parallel/multihost.py``).

One process per device. Every process runs the same script:

    from onet_tpu_torch.parallel import multihost
    dev = multihost.initialize("host0:29500", num_processes=N,
                               process_id=i)
    mesh = make_mesh((N,), ("data",))          # core/mesh.py
    step = make_train_step(mesh=mesh, ...)     # takes the global batch
    x = multihost.global_batch(mesh, local_frames)

``torchrun --nproc-per-node N script.py`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``; pass them on. Nothing
here reads a cluster's configuration on its own.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from onet_tpu_torch.core.device import resolve_device


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               device=None, backend: str = None,
               local_rank: int = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``coordinator``: ``"host:port"`` of process 0 (or an init-method URL,
    ``tcp://...`` or ``file://...``). ``device``: ``None`` or ``"cuda"``
    -> ``cuda:{local_rank}`` (``local_rank`` default: ``LOCAL_RANK`` from
    the environment, else ``process_id`` modulo the card count), which
    becomes the current device; a device with an index is taken as it is
    (processes sharing one card); ``"cpu"``. The backend follows from the
    device: NCCL on the card, gloo on the CPU; ``backend`` overrides it
    (gloo for processes that share a card, which NCCL refuses)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            if local_rank is None:
                local_rank = int(os.environ.get(
                    "LOCAL_RANK", process_id % torch.cuda.device_count()))
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_batch_slice(global_n: int) -> slice:
    """The rows of a global batch this process feeds: a contiguous equal
    split in process order (JAX's, with one process per device)."""
    count = process_count()
    per = global_n // count
    if per * count != global_n:
        raise ValueError(f"global batch {global_n} not divisible by "
                         f"{count} processes")
    i = process_index()
    return slice(i * per, (i + 1) * per)


def global_batch(mesh, local_frames: torch.Tensor, *,
                 spatial: bool = False) -> torch.Tensor:
    """The global [N, H, W, C] batch from every rank's block of it (the
    block ``core/mesh.py::batch_sharding(mesh, spatial=...)`` cuts): the
    blocks are gathered over the mesh and put in their places. Ranks that
    hold the same block (a replicated axis) give the same rows."""
    from onet_tpu_torch.core.mesh import batch_sharding
    from onet_tpu_torch.parallel.collectives import gather_parts

    sh = batch_sharding(mesh, spatial=spatial)
    parts = gather_parts(local_frames.contiguous(), mesh.world)
    grid = {}
    for r, part in zip(mesh.world.ranks, parts):
        pos = mesh.ranks.index(r)
        coords = []
        for s in reversed(tuple(mesh.shape.values())):
            coords.append(pos % s)
            pos //= s
        c = dict(zip(mesh.axis_names, reversed(coords)))
        key = tuple(c.get(a, 0) for a in sh.dims.values())
        grid[key] = part
    dims = list(sh.dims.items())

    def assemble(prefix, level):
        if level == len(dims):
            return grid[tuple(prefix)]
        d, name = dims[level]
        return torch.cat([assemble(prefix + [i], level + 1)
                          for i in range(mesh.shape[name])], dim=d)

    return assemble([], 0)


def fold_process_key(seed: int) -> int:
    """A per-process seed: ``seed`` folded with the process index
    (``core/prng.py::derive_seed``, the port's ``jax.random.fold_in``), so
    processes draw disjoint, reproducible streams."""
    from onet_tpu_torch.core.prng import derive_seed
    return derive_seed(seed, process_index())
