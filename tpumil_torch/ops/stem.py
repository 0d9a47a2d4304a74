"""The ResNet stem in one op (counterpart of tpumil/ops/stem_pallas.py).

``fused_stem(x [B, 224, 224, 3], w7 HWIO [7, 7, 3, 64], compute_dtype)``
returns the post-stem activation ``[B, 56, 56, 64]`` in ``compute_dtype``
(float32 or bfloat16): conv 7x7/s2/p3, InstanceNorm2d(affine=False, eps
1e-5) over the 12,544 pixels of each (image, channel), ReLU, max pool
3x3/s2/p1. The layout is the JAX op's: NHWC images, HWIO weights.

The wrapper launches the hand-written Hopper kernel ``csrc/stem.cu`` on a
CUDA tensor, or raises; on a CPU tensor it runs ``stem_plain``. Numerics:
the conv takes operands in the compute dtype and sums in f32 (true f32 for
the f32 stream, no TF32), its output is rounded to the compute dtype, and
the statistics are taken in f32 of those rounded values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpumil_torch.ops.instance_norm import EPS, instance_norm_plain
from tpumil_torch.utils.device import disable_tf32

H_IN, H_OUT, C_IN, C_OUT = 224, 56, 3, 64
W_SHAPE = (7, 7, C_IN, C_OUT)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stem_plain(x: torch.Tensor, w7: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version (counterpart of ``xla_stem``): the port's
    unfused stem, ``F.conv2d`` as ``models/resnet._conv`` calls it, then
    ``instance_norm_plain`` with ReLU and ``F.max_pool2d``; TF32 off."""
    disable_tf32()
    h = F.conv2d(x.permute(0, 3, 1, 2).to(compute_dtype),
                 w7.permute(3, 2, 0, 1).to(compute_dtype), stride=2, padding=3)
    h = instance_norm_plain(h.permute(0, 2, 3, 1), relu=True)
    return F.max_pool2d(h.permute(0, 3, 1, 2), kernel_size=3, stride=2,
                        padding=1).permute(0, 2, 3, 1).contiguous()


def _check(x: torch.Tensor, w7: torch.Tensor, compute_dtype) -> None:
    if x.dim() != 4 or tuple(x.shape[1:]) != (H_IN, H_IN, C_IN):
        raise ValueError(f"fused_stem expects [B,224,224,3], got "
                         f"{tuple(x.shape)}")
    if tuple(w7.shape) != W_SHAPE:
        raise ValueError(f"fused_stem expects HWIO weights {W_SHAPE}, got "
                         f"{tuple(w7.shape)}")
    if not x.is_floating_point():
        raise ValueError(f"unsupported x dtype {x.dtype}; expected a float")
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}; "
                         "expected float32 or bfloat16")


def fused_stem(x: torch.Tensor, w7: torch.Tensor,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """conv7x7/s2 + InstanceNorm + ReLU + maxpool3x3/s2 of NHWC 224^2
    images (any float dtype, rounded to ``compute_dtype`` as the conv reads
    them); returns a new contiguous ``[B, 56, 56, 64]`` tensor in
    ``compute_dtype``."""
    _check(x, w7, compute_dtype)
    if x.device.type == "cpu":
        return stem_plain(x, w7, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.float()  # the kernel reads f32 (exact for narrower floats)
    if w7.device != x.device or w7.dtype != torch.float32:
        raise ValueError(f"w7 must be float32 on {x.device}, got {w7.dtype} "
                         f"on {w7.device}")
    if not (x.is_contiguous() and w7.is_contiguous()):
        raise ValueError("fused_stem expects contiguous NHWC x and HWIO w7")
    b = x.shape[0]
    out = torch.empty((b, H_OUT, H_OUT, C_OUT), dtype=compute_dtype,
                      device=x.device)
    if b == 0:
        return out
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    # the conv output and per-tile (mean, M2) statistics between the two
    # kernels of csrc/stem.cu
    conv = torch.empty((b, 2 * H_OUT, 2 * H_OUT, C_OUT), dtype=compute_dtype,
                       device=x.device)
    part = torch.empty((b, lib.tpumil_stem_tiles(), C_OUT, 2),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpumil_stem(x.data_ptr(), w7.data_ptr(), conv.data_ptr(),
                              part.data_ptr(), out.data_ptr(), b,
                              _DTYPE_CODES[compute_dtype], EPS, stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    fused_stem.launches += 1
    return out


# kernel launches since the last reset (a plain int: chip_smoke.py and the
# tests zero it and read it to show the main path went through the kernel)
fused_stem.launches = 0
