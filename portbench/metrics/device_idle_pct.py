"""``device_idle_pct.<cell kind>``: the share of the traced window in which
no operation ran on the device, in %: the window less the union of the
device's kernel, copy and memset intervals (averaged over the devices in
use), over the window."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    if not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
