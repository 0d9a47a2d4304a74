"""The comparisons that decide ``correct``, in NumPy.

Training cells compare norms leaf by leaf: the gap between the program's
norm of a leaf and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger (some gradients are all but
zero), and take the worst leaf.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and is left out of the change
NEGLIGIBLE_GRAD = 1e-3


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   keys: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap: the program's norm less the reference's, over
    the reference's norm of that leaf or of the median leaf, the larger."""
    keys = list(want if keys is None else keys)
    med = float(np.median([want[k] for k in want]))
    gaps = [abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys]
    return float(max(gaps)) if gaps else 0.0


def moving_leaves(ref_grad_norms: Dict[str, float]) -> list:
    """Leaves whose reference gradient is not nought to rounding."""
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE_GRAD * med]


def worst_relative(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
