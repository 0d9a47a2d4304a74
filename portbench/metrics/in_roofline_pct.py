"""``in_roofline_pct.<cell kind>``: the instance-norm kernel K4
(``ops/instance_norm.py``, ``csrc/instance_norm.cu``) over the 19 IN sites
of a ResNet18 forward at 224^2, against its roofline, in %.

A site normalizes (and may ReLU) an NHWC ``[B, H, W, C]`` tensor: its
least time is its bytes (read once, written once) over the memory rate;
its operations are a few per element and never bound it. The share is the
bound of every site of every forward in the traced window (the forwards
are K5's launches there) over the device time of K4's kernels.
"""

from __future__ import annotations

from typing import Optional

KERNELS = ("instance_norm_kernel",)
STEM_LAUNCH = "stem_conv_pool_kernel"
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
# (side, channels, sites) of ResNet18's IN sites after the stem at 224^2:
# two a block plus one a downsample
SITES = ((56, 64, 4), (28, 128, 5), (14, 256, 5), (7, 512, 5))


def forward_bytes(b: int, dtype: str) -> float:
    return sum(2.0 * DTYPE_BYTES[dtype] * b * s * s * c * n
               for s, c, n in SITES)


def read(ctx, name: str) -> Optional[float]:
    work = ctx.window.counters.get("resnet_forward")
    secs, _ = ctx.trace.seconds_matching(KERNELS)
    _, forwards = ctx.trace.seconds_matching((STEM_LAUNCH,))
    if work is None or secs <= 0 or not forwards:
        return None
    b = ctx.window.counters["batch_size"]
    bound = forwards * forward_bytes(b, work["dtype"]) \
        / ctx.peaks["bytes_per_s"]
    return 100.0 * bound / secs
