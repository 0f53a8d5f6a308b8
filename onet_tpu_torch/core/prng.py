"""Random streams (``onet_tpu/core/prng.py``).

The reference pins ``torch.manual_seed(1981); np.random.seed(1981)`` at
import. The JAX package threads explicit keys instead; here a seed becomes
a dispenser of ``torch.Generator``s whose seeds are derived
deterministically from (seed, n) with ``numpy.random.SeedSequence``, so the
same seed gives the same streams on every run and every device type.

``jax.random`` streams cannot be reproduced in torch: the same seed gives
other numbers than the JAX package. Tests carry JAX's draws across where a
comparison must be exact, and hold the rest statistically.

A draw on the card needs a generator on the card: ``next()`` makes each
generator on the device it is asked for, so draws happen where the data
lives, with no host draw and copy.
"""

from __future__ import annotations

import numpy as np
import torch

from onet_tpu_torch.core.device import resolve_device

DEFAULT_SEED = 1981


def derive_seed(*words: int) -> int:
    """A 63-bit seed derived from a sequence of non-negative ints (the
    counterpart of ``jax.random.fold_in``)."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def make_generator(seed: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default: the card; raises without one)
    seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


class RngStream:
    """A dispenser of generators. Not thread-safe; one per driver."""

    def __init__(self, seed: int = DEFAULT_SEED, device=None):
        self.seed = seed
        self.device = resolve_device(device)
        self._n = 0

    def next_seed(self) -> int:
        """The seed of the stream's next generator, derived from (seed, n)."""
        self._n += 1
        return derive_seed(self.seed, self._n)

    def next(self, device=None) -> torch.Generator:
        """The next generator, on ``device`` (default: the stream's)."""
        return make_generator(self.next_seed(),
                              self.device if device is None else device)

    def split(self, n: int):
        return [self.next() for _ in range(n)]
