"""``host_ms_per_step.<cell kind>``: the mean length of the program's
``<cell kind>.step`` spans (``tpumil_torch.utils.prof``) in the traced
window, in ms: the host's time from a bag's ``zero_grad`` to Adam's
return, device waits included. Nothing to read where the window recorded
no spans."""

from __future__ import annotations

from typing import Optional


def read(ctx, name: str) -> Optional[float]:
    step = name.split(".", 1)[1] + ".step"
    steps = [s for s in getattr(ctx.trace, "spans", ()) if s[0] == step]
    if not steps:
        return None
    return sum(s[5] - s[4] for s in steps) / len(steps) / 1e3
