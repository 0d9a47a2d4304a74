"""Job-level work sharding for the per-bag pipeline stages (counterpart of
tpumil/utils/sharding.py).

Feature extraction is independent per bag, so its scale-out is by bag:
every process runs the same command with ``--shard i/n`` and takes the bags
at positions i, i+n, i+2n, ... of the sorted work list. No coordination is
needed; the dataset CSVs are assembled once afterwards.
"""

from __future__ import annotations

from typing import Optional, Tuple


def parse_shard(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """'i/n' -> (i, n) with 0 <= i < n; None passes through."""
    if spec is None:
        return None
    try:
        i_s, n_s = spec.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"--shard must look like 'i/n', got {spec!r}") from None
    if n <= 0 or not 0 <= i < n:
        raise ValueError(f"--shard needs 0 <= i < n, got {spec!r}")
    return i, n
