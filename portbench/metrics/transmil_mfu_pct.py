"""``transmil_mfu_pct.<cell kind>``: TransMIL's operations in the traced
window, counted from the bag sizes of the epochs the driver ran
(``counters["transmil"]``), over the window's length by the host clock, as
a share of the card's f32 peak (``peaks.json``), in %.

A step on a bag of N instances, K features, width D, h heads, m landmarks,
i pseudo-inverse iterations, a residual convolution of r taps, C classes,
counted as the published code computes it (2 operations a multiply-add;
softmax, layer norms and elementwise work not counted): the grid holds
S = H^2 rows, H = ceil(sqrt(N)); each layer pads its T = S + 1 rows to
P = m ceil(T / m). A layer's forward:

    8 P D^2              q, k, v and the output projection
    8 D P m              q k~^T, q~ k^T, A3 v, (A1 Z)(A3 v)
    2 D m^2              q~ k~^T
    8 i h m^3            the pseudo-inverse: 4 products an iteration
    2 h P m^2            A1 Z
    2 r D P              the residual convolution

the PPEG's forward ``2 D S (49 + 25 + 9)``, the head's ``2 D C``, and the
embedding's ``2 N K D``. The backward takes both gradients of every
product (twice the forward) but the embedding's, whose input needs none.
The port computes the rows past the landmarks for the last T rows alone,
so its own count is a little lower at small bags.
"""

from __future__ import annotations

import math
from typing import Optional

PPEG_TAPS = (7, 5, 3)


def layer_forward_flops(p: int, d: int, heads: int, m: int, iters: int,
                        taps: int) -> float:
    return float(8 * p * d * d + 8 * d * p * m + 2 * d * m * m
                 + 8 * iters * heads * m ** 3 + 2 * heads * p * m * m
                 + 2 * taps * d * p)


def step_flops(n: int, k: int = 1024, c: int = 2, d: int = 512,
               heads: int = 8, m: int = 256, iters: int = 6,
               taps: int = 33) -> float:
    """One training step (forward and backward) on a bag of ``n``."""
    side = math.isqrt(n - 1) + 1
    s = side * side
    p = m * -(-(s + 1) // m)
    fwd = 2 * layer_forward_flops(p, d, heads, m, iters, taps) \
        + 2 * d * s * sum(t * t for t in PPEG_TAPS) + 2 * d * c
    return 3.0 * fwd + 4.0 * n * k * d


def window_flops(w: dict) -> float:
    per_epoch = sum(step_flops(int(n), w["k"], w["c"], w["d"], w["heads"],
                               w["landmarks"], w["iterations"], w["taps"])
                    for n in w["sizes"])
    return w["epochs"] * per_epoch


def read(ctx, name: str) -> Optional[float]:
    w = ctx.window.counters.get("transmil")
    if w is None or ctx.trace.window_s <= 0:
        return None
    flops = window_flops(w)
    if flops <= 0:
        return None
    return 100.0 * flops / ctx.trace.window_s \
        / ctx.peaks["flops_per_s"]["float32"]
