"""Preemption guard: SIGTERM becomes a drain-and-checkpoint flag
(``onet_tpu/train/preempt.py``).

Batch schedulers and preemptible machines send SIGTERM before the kill; a
driver that ignores it loses everything since its last milestone (the
reference saves only at epoch 300 and the final epoch). Drivers install
the guard around their epoch loop, poll ``triggered`` at step boundaries,
write a checkpoint on preemption and return; the resumed run redoes the
interrupted epoch in full.

Signal handlers are process-wide and can be set only from the main
thread; elsewhere (a trainer driven from a worker thread) the guard is an
inert flag.

Under a mesh the ranks must stop at the same step: ``triggered_on_any``
all-reduces the flag with MAX, so a SIGTERM on any rank stops them all.
The reduction is read one call late, so the host does not wait for the
card at every step: a SIGTERM during step k stops every rank after step
k + 1 (or at the epoch's end, ``settled_on_any``).
"""

from __future__ import annotations

import signal
import threading


class PreemptGuard:
    """install() -> poll .triggered -> restore(). Each install chains the
    handler it replaced back on restore."""

    def __init__(self, enabled: bool = True):
        self.enabled = (enabled and threading.current_thread()
                        is threading.main_thread())
        self._event = threading.Event()
        self._old = None
        self._installed = False
        # the mesh agreement: the reduction in flight, the agreed flag
        self._pending = None
        self._agreed = False

    def install(self) -> "PreemptGuard":
        if self.enabled:
            self._old = signal.signal(
                signal.SIGTERM, lambda signum, frame: self._event.set())
            self._installed = True
        return self

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._old)
            self._installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def triggered_on_any(self, axis=None, device=None) -> bool:
        """``triggered`` on any rank of ``axis`` (``core/mesh.py::Axis``;
        None: this process alone, at once). Starts the MAX all-reduce of
        this rank's flag without waiting for it and returns what the
        previous call's reduction agreed (latched once true). Every rank
        of the axis must make the same calls in the same order, so every
        rank reads the same answer at the same step. ``device``: where
        the flag is reduced (the card for NCCL; gloo reduces on the
        host)."""
        if axis is None or axis.group is None:
            return self.triggered
        import torch
        import torch.distributed as dist
        agreed = self.settled_on_any(axis)
        on_card = dist.get_backend(axis.group) != "gloo"
        flag = torch.tensor([1.0 if self.triggered else 0.0],
                            device=device if on_card else "cpu")
        work = dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                               group=axis.group, async_op=True)
        if on_card:
            work.wait()              # the stream waits for it, not the host
            host = torch.empty(1, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._pending = (done.synchronize, host)
        else:
            self._pending = (work.wait, flag)
        return agreed

    def settled_on_any(self, axis=None) -> bool:
        """``triggered_on_any``'s answer with the reduction it last
        started waited for: call it where every rank decides to stop
        (the epoch's end)."""
        if axis is None or axis.group is None:
            return self.triggered
        if self._pending is not None:
            wait, value = self._pending
            wait()
            self._agreed = self._agreed or bool(value[0] > 0)
            self._pending = None
        return self._agreed
