"""Frozen open-loop arrival schedules.

``exp_quantile_gaps``: a fixed schedule, not a random Poisson process.
Its n = rate x seconds inter-arrival gaps are the exponential
distribution's quantiles at the midpoints of n equal steps (the gaps a
Poisson process at ``rate`` has, smoothed: no two schedules differ in
their set of gaps), scaled so that the schedule spans ``seconds``
exactly, in an order the seed draws. So the number of requests is fixed,
and a cell that passes one seed offers the identical sequence in every
run.
"""

from __future__ import annotations


import numpy as np

from benchmark.traffic.frames import rng


def exp_quantile_gaps(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in seconds from the window's start, ascending."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()          # the schedule spans the window
    order = rng(seed, 3).permutation(n)
    due = np.cumsum(gaps[order]) - gaps[order][0]
    return due


SCHEDULES = {"exp_quantile_gaps": exp_quantile_gaps}


def schedule(kind: str, rate: float, seconds: float, seed: int):
    if kind not in SCHEDULES:
        raise ValueError(f"unknown arrival schedule {kind!r}; have "
                         f"{sorted(SCHEDULES)}")
    return SCHEDULES[kind](rate, seconds, seed)
