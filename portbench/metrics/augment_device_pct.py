"""``augment_device_pct.<cell kind>``: the share of the traced window's
device time (every operation's length, summed) spent in operations
launched inside the program's ``<cell kind>.augment`` spans (the
on-device augmentation, ``ops/augment.py``), each paired with its launch
call by correlation id, in %. Nothing to read where the window recorded
no spans or no correlation ids."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    kind = name.split(".", 1)[1]
    tr = ctx.trace
    if not getattr(tr, "spans", ()) or not any(getattr(tr, "device_corr",
                                                       ())):
        return None
    total = sum(t - s for _, s, t, _, _ in tr.device) / 1e6
    secs = tr.device_seconds_inside(f"{kind}.augment")
    return 100.0 * secs / total if secs > 0 else None
