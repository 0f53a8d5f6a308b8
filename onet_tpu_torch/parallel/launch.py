"""Starting the ranks of a multi-device command.

The JAX package is single-controller: one process drives every device of
its mesh. The port is multi-controller (``parallel/multihost.py``): one
process a device, each holding its block and calling the collectives. So
the command line's ``--dp``, ``--pp`` and ``--sp`` start one process per
rank:

* under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` set), each process it
  started joins that world (``join``), whose size must be what the flags
  need;
* otherwise ``run_world`` spawns the ranks itself, as ``chip_smoke.py``'s
  worlds do: a file rendezvous in a fresh temporary directory, each rank
  calling ``multihost.initialize`` (NCCL on ``cuda:r``, gloo on the CPU,
  or the ``backend`` asked for: gloo lets several ranks share one card).

Ranks on the CPU split the caller's intra-op threads between them. Each
rank runs
``fn(*args)``; its return values come back to the caller
in rank order. A rank that raises ends the world: the others are
stopped, and the caller gets that rank's traceback (``RankError``), or
the message of a rank that refused with ``SystemExit``. Only
rank 0 prints: the others' standard output goes nowhere. A script that
spawns ranks must guard its top level with ``if __name__ ==
"__main__"``: each spawned process imports it again.
"""

from __future__ import annotations

import os
import queue
import shutil
import sys
import tempfile
import traceback

import torch

_DEVICE = None          # this rank's device, once it joined a world


class RankError(RuntimeError):
    """A rank of a spawned world failed; the message holds its traceback
    (or, where it refused with ``SystemExit``, that message)."""


def device():
    """This rank's device (``multihost.initialize``'s), None outside a
    world started here."""
    return _DEVICE


def torchrun_env():
    """(world size, rank, "host:port") from torchrun's environment, or
    None outside ``torchrun``."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    return (int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
            f"{addr}:{port}")


def visible_devices(device) -> int | None:
    """How many ranks ``device`` seats, one a device: the card count for
    ``cuda``, None (any number) for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _quiet(rank: int) -> None:
    if rank:
        sys.stdout = open(os.devnull, "w")


def join(n: int, device=None) -> torch.device:
    """Under ``torchrun``: join its world as this process's rank and
    return the rank's device. The world must hold ``n`` processes."""
    global _DEVICE
    from onet_tpu_torch.parallel import multihost

    world, rank, addr = torchrun_env()
    if world != n:
        raise SystemExit(f"the command needs {n} processes, one a device; "
                         f"torchrun started {world} (--nproc-per-node)")
    _quiet(rank)
    _DEVICE = multihost.initialize(addr, world, rank, device=device)
    return _DEVICE


def _child(rank, n, url, device, backend, quiet, threads, fn, args, q):
    global _DEVICE
    if quiet:
        _quiet(rank)
    if threads:
        torch.set_num_threads(threads)
    try:
        from onet_tpu_torch.parallel import multihost
        _DEVICE = multihost.initialize(url, n, rank, device=device,
                                       backend=backend)
        out = fn(*args)
    except BaseException as e:
        err = (str(e.code) if isinstance(e, SystemExit) and
               isinstance(e.code, str) else
               f"rank {rank} failed:\n{traceback.format_exc()}")
        q.put((rank, err, None))
        q.close()
        q.join_thread()
        sys.exit(1)
    import torch.distributed as dist
    dist.barrier()
    q.put((rank, None, out))
    dist.destroy_process_group()


def run_world(n: int, device, fn, *args, backend: str = None,
              quiet: bool = False) -> list:
    """Spawn ``n`` ranks on ``device`` (``None`` / ``"cuda"``: rank r on
    ``cuda:r``; ``"cuda:k"`` with ``backend="gloo"``: every rank on card
    k; ``"cpu"``: gloo on the CPU), each running ``fn(*args)``; returns
    their results in rank order. ``quiet``: ranks other than 0 print
    nothing. Raises ``RankError`` with the traceback of the first rank
    that fails (the others are stopped), the message of one that refuses
    (``SystemExit``) or the exit code of one that dies."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="onet_ranks_")
    url = "file://" + os.path.join(tmp, "rendezvous")
    threads = None        # ranks on the CPU share this process's threads
    if torch.device("cuda" if device is None else device).type == "cpu":
        threads = max(1, torch.get_num_threads() // n)
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, n, url, device, backend, quiet, threads,
                               fn, args, q)) for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            try:
                rank, err, out = q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode}")
                continue
            if err is not None:
                raise RankError(err)
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(n)]


def launch(n: int, device, fn, *args):
    """The command line's entry: run ``fn(*args)`` on ``n`` ranks, one a
    device. Under ``torchrun`` this process joins its world and runs its
    rank; else the ranks are spawned here. A failing rank exits the
    command with its traceback."""
    if torchrun_env() is not None:
        join(n, device)
        try:
            return fn(*args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    try:
        return run_world(n, device, fn, *args, quiet=True)[0]
    except RankError as e:
        raise SystemExit(str(e)) from None
