"""The general traffic generator: clips and arrival schedules from the seed.

A serving mix is a pool of distinct clips (packed YUV420 crops, random
bytes) that requests draw from in a seeded order, offered by a closed loop
of clients or by an open loop on a schedule. Every seed of an open loop
gets the same set of gaps between arrivals, in its own order, so seeds
differ in order and content and not in the amount of work.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use (``stream``) of one seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(stream)]))


def random_bytes(gen: np.random.Generator, shape: Tuple[int, ...]) -> np.ndarray:
    return np.frombuffer(gen.bytes(math.prod(shape)), np.uint8).reshape(shape).copy()


def yuv_clip_pool(seed: int, clips: int, frames: int, size: int) -> np.ndarray:
    """(clips, frames, size*size*3/2) uint8 packed YUV420 crops."""
    return random_bytes(rng(seed, 1), (clips, frames, size * size * 3 // 2))


def request_clips(seed: int, count: int, pool: int) -> np.ndarray:
    """The pool index of each request: the pool in a seeded order, again
    and again."""
    gen = rng(seed, 2)
    return np.concatenate([gen.permutation(pool) for _ in range(-(-count // pool))])[:count]


def poisson_offsets(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the start) of ``round(rate * seconds)`` arrivals
    whose gaps are the exponential distribution's quantiles at the midpoints
    of ``count`` equal steps, shuffled by the seed: Poisson arrivals at
    ``rate`` with the same gaps for every seed."""
    count = max(1, int(round(rate * seconds)))
    u = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-u) / rate
    return np.cumsum(rng(seed, 3).permutation(gaps))


def face_clips(seed: int, clips: int, frames: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Training clips (clips, frames, size, size, 3) uint8, every one
    distinct, and their labels, half fake."""
    faces = random_bytes(rng(seed, 4), (clips, frames, size, size, 3))
    labels = (np.arange(clips) % 2).astype(np.int64)
    return faces, labels


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank (``inf`` for a missing value
    sorts last)."""
    s = sorted(values)
    return float(s[max(0, math.ceil(q * len(s)) - 1)])
