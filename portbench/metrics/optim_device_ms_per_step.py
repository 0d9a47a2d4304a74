"""``optim_device_ms_per_step.<cell kind>``: the device time of the
operations launched inside the program's ``<cell kind>.optim`` spans
(Adam's step), each operation paired with its launch call by correlation
id, over the ``<cell kind>.step`` spans, in ms. Nothing to read where the
window recorded no spans or no correlation ids."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    kind = name.split(".", 1)[1]
    tr = ctx.trace
    steps = sum(s[0] == f"{kind}.step" for s in getattr(tr, "spans", ()))
    if not steps or not any(getattr(tr, "device_corr", ())):
        return None
    secs = tr.device_seconds_inside(f"{kind}.optim")
    return secs * 1e3 / steps if secs > 0 else None
