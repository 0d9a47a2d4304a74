"""``stem_roofline_pct.<cell kind>``: the ResNet stem's kernel K5
(``ops/stem.py``, ``csrc/stem.cu``: conv 7x7/s2, instance norm, ReLU and
max pool 3x3/s2 of 224^2 NHWC images) against its roofline, in %.

The least time one launch could take on a batch of B images is the larger
of its operations over the peak rate of its dtype and its bytes over the
memory rate (each input byte read once: the images and the weight; each
output byte written once: the pooled ``[B, 56, 56, 64]``). The share is
that bound, summed over the traced window's launches, over the device
time of K5's kernels (both passes) in the trace.
"""

from __future__ import annotations

from typing import Optional

KERNELS = ("stem_conv_pool_kernel", "stem_norm_kernel")
LAUNCH_KERNEL = "stem_conv_pool_kernel"
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def stem_flops(b: int) -> float:
    return 2.0 * b * 112 * 112 * 64 * 3 * 7 * 7


def stem_bytes(b: int, dtype: str) -> float:
    """Images in f32 (the kernel reads them as the caller holds them),
    the weight in f32, the pooled output in the compute dtype."""
    return 4.0 * (b * 224 * 224 * 3 + 64 * 3 * 7 * 7) \
        + DTYPE_BYTES[dtype] * b * 56 * 56 * 64


def stem_bound_s(b: int, dtype: str, peaks: dict) -> float:
    return max(stem_flops(b) / peaks["flops_per_s"][dtype],
               stem_bytes(b, dtype) / peaks["bytes_per_s"])


def read(ctx, name: str) -> Optional[float]:
    work = ctx.window.counters.get("resnet_forward")
    secs, _ = ctx.trace.seconds_matching(KERNELS)
    _, launches = ctx.trace.seconds_matching((LAUNCH_KERNEL,))
    if work is None or secs <= 0 or not launches:
        return None
    b = ctx.window.counters["batch_size"]
    bound = launches * stem_bound_s(b, work["dtype"], ctx.peaks)
    return 100.0 * bound / secs
