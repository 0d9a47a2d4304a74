"""InstanceNorm2d(affine=False) (+ReLU) over NHWC activations (counterpart
of tpumil/ops/in_pallas.py).

``fused_instance_norm`` is the wrapper of the hand-written Hopper kernel
``csrc/instance_norm.cu``. It takes ``x`` as a contiguous ``[N, H, W, C]``
tensor; an NCHW tensor in ``torch.channels_last`` format is passed as
``t.permute(0, 2, 3, 1)``, a view of the same memory (no copy). Semantics
are torch's InstanceNorm2d(affine=False, eps=1e-5): per (sample, channel)
statistics in f32 over the stored values, biased variance, eps inside the
rsqrt, output cast back to the input dtype.

On a CPU tensor the wrapper runs ``instance_norm_plain``; on a CUDA tensor
it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import torch

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_plain(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """The plain PyTorch version over NHWC ``x``: the two-pass form of
    tpumil/models/resnet.py::_norm (variance never negative)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + EPS)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected a rank-4 [N, H, W, C] tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}; expected float32 or "
                         "bfloat16")
    if not x.is_contiguous():
        raise ValueError(
            "expected NHWC-contiguous memory (an NCHW channels_last tensor "
            "is passed as t.permute(0, 2, 3, 1)); got strides "
            f"{x.stride()} for shape {tuple(x.shape)}")


def fused_instance_norm(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """InstanceNorm2d(affine=False)(x) (+ReLU) over contiguous NHWC ``x``
    (f32 or bf16); returns a new tensor of the same shape and dtype."""
    _check(x)
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from tpumil_torch.utils.build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpumil_instance_norm(x.data_ptr(), y.data_ptr(), n, h * w, c,
                                       _DTYPE_CODES[x.dtype], int(relu), EPS,
                                       stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: CUDA error "
                           f"{err}")
    fused_instance_norm.launches += 1
    return y


# kernel launches since the last reset (a plain int: chip_smoke.py and the
# tests zero it and read it to show the main path went through the kernel)
fused_instance_norm.launches = 0
