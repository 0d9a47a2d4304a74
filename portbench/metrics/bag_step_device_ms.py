"""``bag_step_device_ms``: the device's busy time per bag step, in ms: the
union of the device's kernel, copy and memset intervals over the window
(averaged over the devices in use), over the steps the driver completed
in it (``counters["steps"]``). What a step costs the card, whatever the
host adds around it; the host's share is ``step_wall_ms``."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    steps = ctx.window.counters.get("steps", 0)
    if not steps or not ctx.trace.device:
        return None
    return ctx.trace.busy_s * 1e3 / steps
