"""``copy_share_pct.<cell kind>``: the share of the traced window's device
time spent in copy and layout kernels, in %: the strided copies that turn
one memory format into another (ATen's direct copy kernels, cuDNN's
NCHW/NHWC transforms, transposes). Their names are matched below."""

from __future__ import annotations

from typing import Optional

COPY_KERNELS = ("direct_copy_kernel", "copy_kernel", "nchwToNhwc",
                "nhwcToNchw", "transpose", "Transpose")


def read(ctx, name: str) -> Optional[float]:
    total = sum(t - s for _, s, t, kind, _ in ctx.trace.device
                if kind == "kernel")
    if total <= 0:
        return None
    secs, _ = ctx.trace.seconds_matching(COPY_KERNELS)
    return 100.0 * secs * 1e6 / total
