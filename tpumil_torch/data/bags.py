"""Bags and their bucket bookkeeping (a copy of tpumil/data/bags.py's
framework-free part; ``tpumil/__init__.py`` imports JAX).

The port trains and evaluates every bag unpadded, one step per bag. The
bucket length (the next power of two) is kept only as bookkeeping: grouping
the visitation order by bucket, as the JAX trainer does for XLA's static
shapes, keeps the order in which bags are visited, and so the host RNG
draws, identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Bag:
    """One bag: instance features [N, K] and a multi-hot label [C]."""
    feats: np.ndarray
    label: np.ndarray
    name: str = ""

    @property
    def num_instances(self) -> int:
        return int(self.feats.shape[0])


def bucket_length(n: int, min_bucket: int = 16) -> int:
    """Smallest power-of-two >= n (>= min_bucket)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def bucketed_chunks(bags: Sequence[Bag], order: Sequence[int],
                    chunk_size: int = 32, min_bucket: int = 16,
                    ) -> Iterator[Tuple[List[int], int]]:
    """Group a (shuffled) visitation ``order`` into chunks whose members share
    one bucket length, preserving order within a bucket. Yields
    ``(indices, bucket length)``; chunks are emitted when full, then the
    partial ones in order of first appearance."""
    pending: dict[int, List[int]] = {}
    emitted: List[Tuple[List[int], int]] = []
    for idx in order:
        b = bucket_length(bags[idx].num_instances, min_bucket)
        pending.setdefault(b, []).append(idx)
        if len(pending[b]) == chunk_size:
            emitted.append((pending.pop(b), b))
    for b, idxs in pending.items():
        emitted.append((idxs, b))
    yield from emitted
