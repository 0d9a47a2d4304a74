"""``step_wall_ms.<cell kind>``: the window's length by the host clock, to
the end of its last unit of work, over the steps the driver completed in
it (``counters["steps"]``), in ms. Read from a traced window, which the
profiler makes slower than an untraced one where the host sets the step."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    steps = ctx.window.counters.get("steps", 0)
    if not steps or ctx.window.seconds <= 0:
        return None
    return ctx.window.seconds * 1e3 / steps
