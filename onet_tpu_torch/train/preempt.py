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
