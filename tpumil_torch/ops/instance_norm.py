"""InstanceNorm2d(affine=False) (+ReLU) over NHWC activations (counterpart
of tpumil/ops/in_pallas.py).

``fused_instance_norm`` is the wrapper of the hand-written Hopper kernel
``csrc/instance_norm.cu``. It takes ``x`` as a contiguous ``[N, H, W, C]``
tensor; an NCHW tensor in ``torch.channels_last`` format is passed as
``t.permute(0, 2, 3, 1)``, a view of the same memory (no copy). Semantics
are torch's InstanceNorm2d(affine=False, eps=1e-5): per (sample, channel)
statistics in f32 over the stored values, biased variance, eps inside the
rsqrt, output cast back to the input dtype.

The kernel has two routes, and ``plan_instance_norm`` picks one from the
shape and dtype alone: the one-read route holds the plane of one (sample,
block of channels) on chip, spread over a thread-block cluster of up to 8
CTAs, and reads each element of device memory once; planes too large for a
cluster of 8 take the two-read route. Both are hand-written kernels.

On a CPU tensor the wrapper runs ``instance_norm_plain``; on a CUDA tensor
it launches the planned route or raises — it never falls back to the other
route or to the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# one-read route: a CTA holds at most SLICE_MAX bytes of its plane (one CTA
# per SM, beside its reduction scratch), and the planner takes the smallest
# cluster whose slices fit: on the H100, fewer and larger CTAs ran the
# ResNet18 planes fastest (tools/in_sweep.py)
SLICE_MAX = 200 * 1024
CLUSTER_SIZES = (1, 2, 4, 8)
ROW_BYTES = 256  # channels per block: whole 256-byte rows where C allows


class INPlan(NamedTuple):
    """The route of one ``fused_instance_norm`` launch: ``cluster`` CTAs
    share the plane of one (sample, block of ``cblock`` channels), each
    holding ceil(H W / cluster) spatial rows; ``cluster == 0`` is the
    two-read route."""
    route: str
    cluster: int
    cblock: int


def plan_instance_norm(shape: Sequence[int], dtype: torch.dtype) -> INPlan:
    """The route for an ``[N, H, W, C]`` tensor of ``dtype``: the one-read
    route with the smallest cluster whose per-CTA slice fits ``SLICE_MAX``
    bytes, else the two-read route. The batch size does not enter: a plane
    is one sample's."""
    _, h, w, c = shape
    elt = _ELEMENT_BYTES[dtype]
    cblock = min(c, ROW_BYTES // elt)
    for cluster in CLUSTER_SIZES:
        if -(-h * w // cluster) * cblock * elt <= SLICE_MAX:
            return INPlan("one_read", cluster, cblock)
    return INPlan("two_read", 0, c)


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


def refuse_grad(op: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record ``op``: on a CUDA tensor the kernel
    writes a fresh buffer through ctypes, whose output has no autograd
    history, so a gradient would silently stop there (on every device, so
    that a CPU run cannot hide it)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{op} has no backward: it takes no input that requires grad "
            "(a trainable ResNet runs the differentiable conv route)")


def fused_instance_norm(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """InstanceNorm2d(affine=False)(x) (+ReLU) over contiguous NHWC ``x``
    (f32 or bf16); returns a new tensor of the same shape and dtype. Raises
    ``ValueError`` for an ``x`` that requires grad while grad mode is on."""
    _check(x)
    refuse_grad("fused_instance_norm", x)
    if x.device.type == "cpu":
        return instance_norm_plain(x, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from tpumil_torch.utils.build import load_library

    plan = plan_instance_norm(x.shape, x.dtype)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpumil_instance_norm(x.data_ptr(), y.data_ptr(), n, h * w, c,
                                       _DTYPE_CODES[x.dtype], int(relu), EPS,
                                       plan.cluster, plan.cblock, stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed ({plan}): "
                           f"CUDA error {err}")
    fused_instance_norm.launches += 1
    return y


# kernel launches since the last reset (a plain int: chip_smoke.py and the
# tests zero it and read it to show the main path went through the kernel)
fused_instance_norm.launches = 0
