"""Plain PyTorch ResNet18 with InstanceNorm2d(affine=False), fc removed
(torchvision's resnet18 with the reference's norm_layer, compute_feats.py
and simclr/models/resnet_simclr.py), and the reference's JPEG decode.

Weights are a dict under torchvision's names (``conv1.weight``,
``layer1.0.conv1.weight``, ..., ``layer2.0.downsample.0.weight``). Input is
NHWC in [0, 1]; the output is the pooled ``[B, 512]`` feature. NCHW, one
library call per operation, statistics over each (sample, channel) plane
with the biased variance and eps 1e-5. ``dtype`` bf16 runs every
convolution on bf16 operands and keeps activations in bf16, with the norm's
statistics in f32, as a bf16 forward of the reference does under autocast.

Imports torch and PIL alone: nothing of the program.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STAGES = ((64, 2), (128, 2), (256, 2), (512, 2))
EPS = 1e-5


def conv_shapes() -> List[Tuple[str, Tuple[int, int, int, int], int]]:
    """(name, OIHW shape, stride) of every convolution, torchvision order."""
    out = [("conv1.weight", (64, 3, 7, 7), 2)]
    c_in = 64
    for s, (width, blocks) in enumerate(STAGES):
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            p = f"layer{s + 1}.{b}"
            out.append((f"{p}.conv1.weight", (width, c_in, 3, 3), stride))
            out.append((f"{p}.conv2.weight", (width, width, 3, 3), 1))
            if stride != 1 or c_in != width:
                out.append((f"{p}.downsample.0.weight", (width, c_in, 1, 1),
                            stride))
            c_in = width
    return out


def make_weights(generator, device) -> Dict[str, torch.Tensor]:
    """Kaiming-normal convolutions (std sqrt(2 / fan_out), torchvision's
    init), in one draw on ``device``."""
    shapes = conv_shapes()
    sizes = [math.prod(s) for _, s, _ in shapes]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, shape, _), n in zip(shapes, sizes):
        std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        out[name] = (flat[at:at + n] * std).reshape(shape).contiguous()
        at += n
    return out


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype statistics are taken in: f32, or f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _norm(x: torch.Tensor, relu: bool) -> torch.Tensor:
    xf = x.to(_wide(x.dtype))
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + EPS)).to(x.dtype)
    return torch.relu(y) if relu else y


def _conv(x, w, stride, dtype):
    w = w.to(dtype)
    return F.conv2d(x, w, stride=stride,
                    padding=(w.shape[-1] - 1) // 2)


def forward(weights: Dict[str, torch.Tensor], images: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pooled features ``[B, 512]`` (f32; f64 for f64) of NHWC ``images``
    in [0, 1]."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    x = _norm(_conv(x, weights["conv1.weight"], 2, dtype), True)
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for s, (_, blocks) in enumerate(STAGES):
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            stride = 2 if s > 0 and b == 0 else 1
            h = _norm(_conv(x, weights[f"{p}.conv1.weight"], stride, dtype),
                      True)
            h = _norm(_conv(h, weights[f"{p}.conv2.weight"], 1, dtype), False)
            key = f"{p}.downsample.0.weight"
            idt = x if key not in weights else _norm(
                _conv(x, weights[key], stride, dtype), False)
            x = torch.relu(h + idt)
    # pooled in the activations' dtype
    return x.mean(dim=(2, 3)).to(_wide(dtype))


def features(weights, images_u8: torch.Tensor, block: int = 128,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Features of uint8 NHWC images, ``block`` images at a time."""
    with torch.no_grad():
        return torch.cat([forward(weights, images_u8[i:i + block].float()
                                  / 255.0, dtype)
                          for i in range(0, images_u8.shape[0], block)])


def decode_jpegs(paths: Sequence[str], workers: int = 8) -> np.ndarray:
    """The files as uint8 ``[n, H, W, 3]`` RGB, decoded by PIL (the
    reference's ``Image.open(...).convert('RGB')``)."""
    from PIL import Image

    def one(p):
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)

    with ThreadPoolExecutor(workers) as pool:
        return np.stack(list(pool.map(one, paths)))
