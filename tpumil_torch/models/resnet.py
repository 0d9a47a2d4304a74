"""ResNet embedders (18/34/50/101) with instance or batch norm (counterpart
of tpumil/models/resnet.py), built without torchvision.

  * ``state_dict`` names are torchvision's, in ``conv_specs`` order: for
    instance norm only conv weights (InstanceNorm2d(affine=False) has no
    parameters), for batch norm each conv's weight, bias, running_mean and
    running_var follow it (no num_batches_tracked). That order is what the
    reference's positional checkpoint surgery zips onto.
  * Activations run NCHW in ``torch.channels_last`` memory, i.e. NHWC bytes:
    every InstanceNorm(+ReLU) site hands its tensor to the Hopper kernel
    ``ops/instance_norm.fused_instance_norm`` as an NHWC view with no copy.
    Convolutions and the max pool stay ``F.conv2d`` / ``F.max_pool2d``,
    except in the stem of an instance-norm net on 224^2 inputs, which is
    the one Hopper kernel of ``ops/stem.fused_stem`` (K5).
  * Batch norm runs folded running statistics (inference only).
  * ``compute_dtype`` bf16 keeps activations in bf16 between layers; norm
    statistics are always taken in f32. Parameters stay f32.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpumil_torch.ops.instance_norm import fused_instance_norm
from tpumil_torch.ops.stem import C_IN, H_IN, fused_stem
from tpumil_torch.utils.device import disable_tf32

ARCHS = {
    # depth -> (block kind, blocks per stage, feature dim of the pooled output)
    18: ("basic", (2, 2, 2, 2), 512),
    34: ("basic", (3, 4, 6, 3), 512),
    50: ("bottleneck", (3, 4, 6, 3), 2048),
    101: ("bottleneck", (3, 4, 23, 3), 2048),
}
STAGE_WIDTHS = (64, 128, 256, 512)
EPS = 1e-5  # torch norm eps default
STEM_INPUT = (H_IN, H_IN, C_IN)  # the NHWC image shape K5 takes


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    norm: str = "instance"  # "instance" | "batch"
    compute_dtype: torch.dtype = torch.float32
    # Rewrite the 7x7/s2 stem conv as a 2x2 space-to-depth + 4x4/s1 conv
    # (mathematically identical; 12 input channels, a quarter of the
    # spatial positions). Moot where the stem is K5 (instance norm, 224^2).
    space_to_depth: bool = False

    @property
    def block(self) -> str:
        return ARCHS[self.depth][0]

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return ARCHS[self.depth][1]

    @property
    def num_feats(self) -> int:
        return ARCHS[self.depth][2]

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1


# ---------------------------------------------------------------------------
# Parameter specs (torchvision state_dict name order)
# ---------------------------------------------------------------------------

def _block_convs(cfg: ResNetConfig, in_ch: int, width: int, stride: int,
                 prefix: str) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(name, kernel shape OIHW, stride) conv specs of one residual block, in
    torchvision module order (downsample after the main-path convs)."""
    out_ch = width * cfg.expansion
    specs: List[Tuple[str, Tuple[int, ...], int]] = []
    if cfg.block == "basic":
        specs.append((f"{prefix}.conv1.weight", (width, in_ch, 3, 3), stride))
        specs.append((f"{prefix}.conv2.weight", (width, width, 3, 3), 1))
    else:
        specs.append((f"{prefix}.conv1.weight", (width, in_ch, 1, 1), 1))
        specs.append((f"{prefix}.conv2.weight", (width, width, 3, 3), stride))
        specs.append((f"{prefix}.conv3.weight", (out_ch, width, 1, 1), 1))
    if stride != 1 or in_ch != out_ch:
        specs.append((f"{prefix}.downsample.0.weight", (out_ch, in_ch, 1, 1),
                      stride))
    return specs


def conv_specs(cfg: ResNetConfig) -> List[Tuple[str, Tuple[int, ...], int]]:
    """All conv weights (OIHW) in torchvision state_dict order."""
    specs = [("conv1.weight", (64, 3, 7, 7), 2)]
    in_ch = 64
    for stage_idx, (n_blocks, width) in enumerate(zip(cfg.stage_blocks,
                                                      STAGE_WIDTHS)):
        for block_idx in range(n_blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            prefix = f"layer{stage_idx + 1}.{block_idx}"
            specs.extend(_block_convs(cfg, in_ch, width, stride, prefix))
            in_ch = width * cfg.expansion
    return specs


def norm_name_for(conv_name: str) -> str:
    """torchvision pairing: conv1->bn1, layerX.Y.convZ->layerX.Y.bnZ,
    layerX.Y.downsample.0->layerX.Y.downsample.1."""
    if conv_name == "conv1.weight":
        return "bn1"
    base = conv_name[: -len(".weight")]
    if base.endswith("downsample.0"):
        return base[:-1] + "1"
    return base.replace(".conv", ".bn")


def param_names(cfg: ResNetConfig) -> List[str]:
    """state_dict key order (the backbone's parameters and BN statistics)."""
    names: List[str] = []
    for conv_name, _, _ in conv_specs(cfg):
        names.append(conv_name)
        if cfg.norm == "batch":
            bn = norm_name_for(conv_name)
            names.extend(f"{bn}.{p}" for p in
                         ("weight", "bias", "running_mean", "running_var"))
    return names


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _Conv(nn.Module):
    """A bias-free conv weight (OIHW); the stride is applied by the block."""

    def __init__(self, shape: Sequence[int], device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape, device=device),
                                   requires_grad=False)


class _FoldedBatchNorm(nn.Module):
    """BatchNorm2d at inference: scale/shift from the running statistics."""

    def __init__(self, ch: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(ch, device=device),
                                 requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))

    def forward(self, x: torch.Tensor, relu: bool) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + EPS)
        shift = self.bias - self.running_mean * scale
        y = x.float() * scale[:, None, None] + shift[:, None, None]
        return (torch.relu(y) if relu else y).to(x.dtype)


def _instance_norm(x: torch.Tensor, relu: bool) -> torch.Tensor:
    """IN(+ReLU) of an NCHW channels_last tensor through the NHWC kernel."""
    return fused_instance_norm(x.permute(0, 2, 3, 1), relu).permute(0, 3, 1, 2)


class _Block(nn.Module):
    """One residual block; submodule names give torchvision's keys."""

    def __init__(self, cfg: ResNetConfig, specs, device):
        super().__init__()
        self._strides = []
        self._names = []
        batch = cfg.norm == "batch"
        for name, shape, stride in specs:
            leaf = name.split(".")[2]  # conv1 | conv2 | conv3 | downsample
            if leaf == "downsample":
                mods = [_Conv(shape, device)]
                if batch:
                    mods.append(_FoldedBatchNorm(shape[0], device))
                self.downsample = nn.Sequential(*mods)
            else:
                setattr(self, leaf, _Conv(shape, device))
                if batch:
                    setattr(self, leaf.replace("conv", "bn"),
                            _FoldedBatchNorm(shape[0], device))
                self._names.append(leaf)
            self._strides.append(stride)
        self._batch = batch

    def _norm(self, conv_leaf: str, x: torch.Tensor, relu: bool):
        if self._batch:
            if conv_leaf == "downsample":
                return self.downsample[1](x, relu)
            return getattr(self, conv_leaf.replace("conv", "bn"))(x, relu)
        return _instance_norm(x, relu)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = x
        last = len(self._names) - 1
        for i, leaf in enumerate(self._names):
            w = getattr(self, leaf).weight
            h = _conv(h, w, self._strides[i], dtype)
            h = self._norm(leaf, h, relu=i < last)
        identity = x
        if hasattr(self, "downsample"):
            identity = _conv(x, self.downsample[0].weight, self._strides[-1],
                             dtype)
            identity = self._norm("downsample", identity, relu=False)
        return torch.relu(h + identity)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int,
          dtype: torch.dtype) -> torch.Tensor:
    pad = (w.shape[-1] - 1) // 2
    return F.conv2d(x, w.to(dtype), stride=stride, padding=pad)


def _stem_space_to_depth(x: torch.Tensor, w7: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """conv1 7x7/s2/p3 on a 2x2 space-to-depth input: channel packing
    (py, px, c); the kernel padded to 8x8 and regrouped to 12x4x4;
    asymmetric padding (2, 1) reproduces the receptive field exactly
    (tpumil/models/resnet.py::_stem_space_to_depth in NCHW)."""
    b, c, h, w = x.shape
    xs = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4) \
        .reshape(b, 4 * c, h // 2, w // 2)
    cl = torch.channels_last  # keep the conv output in NHWC memory
    xs = F.pad(xs, (2, 1, 2, 1)).contiguous(memory_format=cl)
    o = w7.shape[0]
    wp = F.pad(w7, (1, 0, 1, 0))                       # [O, 3, 8, 8]
    ws = wp.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4) \
        .reshape(o, 4 * c, 4, 4).contiguous(memory_format=cl)
    return F.conv2d(xs, ws.to(dtype))


class ResNet(nn.Module):
    """Pooled-feature ResNet backbone; ``forward`` takes NHWC images."""

    def __init__(self, cfg: ResNetConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        batch = cfg.norm == "batch"
        specs = conv_specs(cfg)
        self.conv1 = _Conv(specs[0][1], device)
        if batch:
            self.bn1 = _FoldedBatchNorm(64, device)
        pos = 1
        for stage_idx, n_blocks in enumerate(cfg.stage_blocks):
            blocks = []
            for block_idx in range(n_blocks):
                prefix = f"layer{stage_idx + 1}.{block_idx}."
                mine = []
                while pos < len(specs) and specs[pos][0].startswith(prefix):
                    mine.append(specs[pos])
                    pos += 1
                blocks.append(_Block(cfg, mine, device))
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*blocks))
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Kaiming-normal conv init (torchvision's: std sqrt(2 / fan_out)),
        drawn on the CPU from ``generator`` so every device gets the same
        weights; BN weight 1, bias 0, running stats (0, 1)."""
        for name, shape, _ in conv_specs(self.cfg):
            fan_out = shape[0] * shape[2] * shape[3]
            std = float(np.sqrt(2.0 / fan_out))
            w = torch.randn(*shape, generator=generator) * std
            self.get_parameter(name).copy_(w)
        for mod in self.modules():
            if isinstance(mod, _FoldedBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, 3] float in [0, 1] (NHWC, like the JAX package).
        Returns pooled features [N, num_feats] float32."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        disable_tf32()
        if cfg.norm == "instance" and tuple(x.shape[1:]) == STEM_INPUT:
            # conv, IN, ReLU and max pool in K5; NHWC out, handed on as its
            # NCHW channels_last view (no copy)
            w7 = self.conv1.weight.permute(2, 3, 1, 0).contiguous()  # HWIO
            x = fused_stem(x.contiguous(), w7, dtype).permute(0, 3, 1, 2)
        else:  # the inputs K5 does not take: batch norm, other sizes
            # the NCHW permute of a contiguous NHWC tensor IS channels_last
            x = x.permute(0, 3, 1, 2).to(dtype)
            if cfg.space_to_depth and x.shape[2] % 2 == 0 \
                    and x.shape[3] % 2 == 0:
                x = _stem_space_to_depth(x, self.conv1.weight, dtype)
            else:
                x = _conv(x, self.conv1.weight, 2, dtype)
            x = self.bn1(x, True) if cfg.norm == "batch" \
                else _instance_norm(x, True)
            x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, dtype)
        return x.mean(dim=(2, 3)).float()


# ---------------------------------------------------------------------------
# Checkpoint import / export
# ---------------------------------------------------------------------------

def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


@torch.no_grad()
def load_torch_state_dict(model: ResNet, sd: Dict[str, object]) -> ResNet:
    """Name-based import of a torchvision-style state_dict (OIHW convs;
    num_batches_tracked ignored); every backbone name must be present."""
    for name in param_names(model.cfg):
        if name not in sd:
            raise KeyError(f"missing {name} in checkpoint")
        _assign(model, name, _as_tensor(sd[name]))
    return model


@torch.no_grad()
def load_positional(model: ResNet, values: List[object]) -> ResNet:
    """Positional import: a checkpoint's values (in saved order, projection
    head already stripped) onto this architecture's names — the reference's
    zip-rename surgery. Count and conv shapes are checked to catch a
    mis-ordered or truncated checkpoint."""
    names = param_names(model.cfg)
    if len(values) != len(names):
        raise ValueError(f"checkpoint has {len(values)} tensors but arch has "
                         f"{len(names)} params (a short checkpoint would "
                         "silently load a truncated backbone)")
    for name, v in zip(names, values):
        _assign(model, name, _as_tensor(v))
    return model


def _assign(model: ResNet, name: str, value: torch.Tensor) -> None:
    try:
        dst = model.get_parameter(name)
    except AttributeError:
        dst = model.get_buffer(name)
    if tuple(dst.shape) != tuple(value.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)} != "
                         f"expected {tuple(dst.shape)}")
    dst.copy_(value)


def export_state_dict(model: ResNet, prefix: str = "") -> "OrderedDict":
    """Backbone tensors (f32, CPU, contiguous OIHW) in torchvision name
    order, each key prefixed."""
    sd = model.state_dict()
    return OrderedDict((prefix + name, sd[name].detach().to("cpu").contiguous())
                       for name in param_names(model.cfg))
