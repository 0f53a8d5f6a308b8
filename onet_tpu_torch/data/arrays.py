"""Device-resident array datasets and batch iteration
(``onet_tpu/data/arrays.py``).

The reference feeds batches through a torch DataLoader with
``num_workers=0``, a host loop copying one batch at a time. Here the whole
(small) dataset stays on the device and an epoch is a device-side gather by
a shuffled index permutation, drawn on the device from a generator there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch


@dataclasses.dataclass
class ArrayDataset:
    """A dict of tensors with one leading length, on one device."""

    data: Dict[str, torch.Tensor]

    def __post_init__(self):
        ns = {k: v.shape[0] for k, v in self.data.items()}
        if len(set(ns.values())) != 1:
            raise ValueError(f"ragged leading dims: {ns}")
        devs = {v.device for v in self.data.values()}
        if len(devs) != 1:
            raise ValueError(f"tensors on several devices: {devs}")

    def __len__(self):
        return next(iter(self.data.values())).shape[0]

    def __getitem__(self, k):
        return self.data[k]

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    def select(self, idx) -> "ArrayDataset":
        return ArrayDataset({k: v[idx] for k, v in self.data.items()})


def _perm(ds: ArrayDataset, gen: torch.Generator) -> torch.Tensor:
    return torch.randperm(len(ds), generator=gen, device=ds.device)


def train_test_split(ds: ArrayDataset, gen: torch.Generator,
                     train_frac: float = 0.9):
    """Shuffled split, train first (the reference's 90/10)."""
    perm = _perm(ds, gen)
    n_train = int(len(ds) * train_frac)
    return ds.select(perm[:n_train]), ds.select(perm[n_train:])


def batch_iterator(ds: ArrayDataset, batch_size: int, *,
                   gen: torch.Generator = None,
                   drop_last: bool = False) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield batches, shuffled by a permutation drawn from ``gen`` if one
    is given. The last partial batch is kept by default (the reference's
    drop_last=False)."""
    n = len(ds)
    order = (_perm(ds, gen) if gen is not None
             else torch.arange(n, device=ds.device))
    stop = (n // batch_size) * batch_size if drop_last else n
    for lo in range(0, stop, batch_size):
        idx = order[lo:lo + batch_size]
        yield {k: v[idx] for k, v in ds.data.items()}


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
