"""``launches_per_step.<cell kind>``: device kernels launched in the traced
window over the steps the driver completed in it (``counters["steps"]``),
in launches/step. Copies and memsets are not launches of a kernel."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    steps = ctx.window.counters.get("steps", 0)
    launches = ctx.trace.kernel_launches()
    if not steps or not launches:
        return None
    return launches / steps
