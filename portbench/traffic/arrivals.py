"""An open loop of requests from a cell's traffic parameters:

    {"rate_per_s": 26.0, "min_patches": 16, "max_patches": 256}

Requests arrive as a Poisson process at ``rate_per_s`` over the window,
and each holds a log-uniform number of patches in ``[min, max]`` (a
viewer's field of view at 20x). The set of sizes and of gaps between
arrivals is fixed by the rate and the window: the quantiles at
``(i + 0.5) / n`` of the log-uniform and of the exponential, for
``n = round(rate * seconds)`` requests. The seed only orders them, so
every seed offers the same work.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def schedule(params: dict, seconds: float, rng: np.random.Generator
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(due times from the window's start [n] in s, patches per request
    [n]), in order of arrival."""
    rate = float(params["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    lo, hi = math.log(params["min_patches"]), math.log(params["max_patches"])
    sizes = np.floor(np.exp(lo + q * (hi - lo))).astype(np.int64)
    gaps = -np.log1p(-q) / rate
    due = np.cumsum(rng.permutation(gaps))
    return due, rng.permutation(sizes)
