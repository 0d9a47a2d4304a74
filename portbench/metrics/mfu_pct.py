"""``mfu_pct.<cell kind>``: the model's operations in the traced window,
counted from the shapes of the work the driver reports, over the window's
length by the host clock, as a share of the card's peak for the model's
dtype (``peaks.json``), in %.

Work the driver may report in its counters, and how it is counted (2
operations a multiply-add; elementwise work, the optimizer and the
augmentation are not counted):

  * ``dsmil``: DSMIL training steps over bags of real size N (not a padded
    bucket), forward and backward, with no gradient of the features;
  * ``resnet_forward``: ResNet18 forwards at 224^2 (the convolutions);
  * ``simclr``: SimCLR views through ResNet18 and the 512-512-256
    projection, forward and backward (no recomputation counted: the
    grad-cache step's second forward is work the method adds).
"""

from __future__ import annotations

from typing import Optional

ATTN = 128
STAGES = ((64, 2), (128, 2), (256, 2), (512, 2))


def dsmil_instance_flops(k: int, c: int, d: int) -> float:
    """Forward and backward, per instance: the instance classifier, the
    query MLP, the logits against the critical queries and the pooling.
    The backward takes the weight gradients of the classifier and of the
    first query layer (the features need none), both gradients of the
    second query layer and of the logits, and the attention's gradient."""
    fwd = 2 * k * c + 2 * k * d + 2 * d * d + 2 * c * d + 2 * c * k
    bwd = 2 * k * c + 2 * k * d + 4 * d * d + 4 * c * d + 2 * c * k
    return float(fwd + bwd)


def dsmil_bag_flops(k: int, c: int) -> float:
    """The bag head, forward and both gradients, once a bag."""
    return float(3 * 2 * c * c * k)


def dsmil_step_flops(n: int, k: int, c: int, d: int) -> float:
    """One training step on a bag of ``n`` instances."""
    return n * dsmil_instance_flops(k, c, d) + dsmil_bag_flops(k, c)


def resnet18_convs(size: int = 224):
    """(c_in, c_out, kernel, h_out, w_out) of every convolution of
    ResNet18 at ``size``^2, the stem first."""
    h = (size + 2 * 3 - 7) // 2 + 1
    convs = [(3, 64, 7, h, h)]
    h = (h + 2 - 3) // 2 + 1  # max pool
    c_in = 64
    for stage, (width, blocks) in enumerate(STAGES):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            h_out = (h + 2 - 3) // stride + 1
            convs.append((c_in, width, 3, h_out, h_out))
            convs.append((width, width, 3, h_out, h_out))
            if stride != 1 or c_in != width:
                convs.append((c_in, width, 1, h_out, h_out))
            c_in, h = width, h_out
    return convs


def conv_flops(c_in: int, c_out: int, k: int, h: int, w: int) -> float:
    return 2.0 * c_in * c_out * k * k * h * w


def resnet18_forward_flops(size: int = 224) -> float:
    return sum(conv_flops(*cv) for cv in resnet18_convs(size))


def simclr_view_flops(size: int = 224, feats: int = 512,
                      out_dim: int = 256) -> float:
    """Forward, then the weight gradient of every layer and the input
    gradient of every layer but the stem (the image needs none)."""
    convs = resnet18_convs(size)
    fwd = sum(conv_flops(*cv) for cv in convs) \
        + 2.0 * (feats * feats + feats * out_dim)
    return 3.0 * fwd - conv_flops(*convs[0])


def window_flops(counters: dict):
    """(operations, dtype) of the work in ``counters``, or None."""
    if "dsmil" in counters:
        w = counters["dsmil"]
        return (w["instances"] * dsmil_instance_flops(w["k"], w["c"], w["d"])
                + w["bags"] * dsmil_bag_flops(w["k"], w["c"]),
                w.get("dtype", "float32"))
    if "resnet_forward" in counters:
        w = counters["resnet_forward"]
        return (w["images"] * resnet18_forward_flops(w["size"]),
                w.get("dtype", "float32"))
    if "simclr" in counters:
        w = counters["simclr"]
        return (w["views"] * simclr_view_flops(w["size"]),
                w.get("dtype", "bfloat16"))
    return None


def read(ctx, name: str) -> Optional[float]:
    work = window_flops(ctx.window.counters)
    if work is None or ctx.trace.window_s <= 0:
        return None
    flops, dtype = work
    if flops <= 0:
        return None
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks["flops_per_s"][dtype]
