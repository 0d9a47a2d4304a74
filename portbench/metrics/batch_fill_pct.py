"""``batch_fill_pct.<cell kind>``: how full the micro-batcher's batches
were over the traced window (``infer/service.py``'s ``ServiceStats``, read
through the service's ``stats()`` before and after the window), in %:
the patches embedded over the batches dispatched times the batch size.
Every request of the window is answered before it closes, so the patches
submitted are the rows dispatched."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    c = ctx.window.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["patches"] / (c["batches"] * c["batch_size"])
