"""SimCLR model: a trainable ResNet backbone (instance norm) and a 2-layer
projection MLP (counterpart of tpumil/models/simclr.py).

Mirrors ResNetSimCLR (simclr/models/resnet_simclr.py:6-37): ``forward``
returns ``(h, z)``, the pooled backbone features and the projection. The
backbone's weights require grad, so it runs the differentiable conv route
(models/resnet.py), never K4 or K5. :func:`export_state_dict` writes the
backbone tensors in torchvision order followed by l1/l2, the layout that
the embedder's positional surgery (``models/embedder.load_simclr_checkpoint``)
consumes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpumil_torch.models import resnet
from tpumil_torch.models.resnet import ResNetConfig
from tpumil_torch.utils.device import disable_tf32

HEAD_KEYS = ("l1.weight", "l1.bias", "l2.weight", "l2.bias")


@dataclasses.dataclass(frozen=True)
class SimCLRConfig:
    base_model: str = "resnet18"     # config.yaml model.base_model
    out_dim: int = 256               # config.yaml model.out_dim
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def resnet_cfg(self) -> ResNetConfig:
        depths = {"resnet18": 18, "resnet50": 50}  # resnet_simclr.py:10-11
        if self.base_model not in depths:
            raise ValueError(f"base_model must be one of {sorted(depths)} "
                             f"(the reference's SimCLR supports these), "
                             f"got {self.base_model!r}")
        return ResNetConfig(depth=depths[self.base_model], norm="instance",
                            compute_dtype=self.compute_dtype)

    @property
    def num_ftrs(self) -> int:
        return self.resnet_cfg.num_feats


class SimCLR(nn.Module):
    """Backbone (``backbone``) plus projection head (``l1``, ``l2``), all
    trainable; parameters are f32, activations in ``compute_dtype``."""

    def __init__(self, cfg: SimCLRConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        n = cfg.num_ftrs
        self.backbone = resnet.ResNet(cfg.resnet_cfg, device)
        self.backbone.requires_grad_(True)
        self.l1 = nn.Linear(n, n, device=device)
        self.l2 = nn.Linear(n, cfg.out_dim, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "SimCLR":
        """Kaiming-normal convs by fan-out; l1/l2 weights and biases
        U(-1/sqrt(n), 1/sqrt(n)), torch Linear's default; drawn on the CPU
        from ``generator`` so every device gets the same weights."""
        self.backbone.init_params(generator)
        lim = 1.0 / np.sqrt(self.cfg.num_ftrs)
        for p in (self.l1.weight, self.l1.bias, self.l2.weight, self.l2.bias):
            u = torch.rand(p.shape, generator=generator)
            p.copy_(u * (2 * lim) - lim)
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 3] in [0, 1] -> (h [B, num_ftrs] f32, z [B, out_dim]
        f32); the head runs in f32 on the f32 features."""
        h = self.backbone(x)
        disable_tf32()
        z = F.linear(torch.relu(F.linear(h, self.l1.weight, self.l1.bias)),
                     self.l2.weight, self.l2.bias)
        return h, z


def init_model(seed: int, cfg: SimCLRConfig,
               device: torch.device) -> SimCLR:
    return SimCLR(cfg, device).init_params(torch.Generator().manual_seed(seed))


def export_state_dict(model: SimCLR) -> "collections.OrderedDict":
    """``features.``-prefixed backbone convs (OIHW) in torchvision order,
    then l1/l2: the SimCLR ``model.pth`` layout."""
    sd = resnet.export_state_dict(model.backbone, prefix="features.")
    head = model.state_dict()
    for key in HEAD_KEYS:
        sd[key] = head[key].detach().to("cpu").contiguous()
    return sd


@torch.no_grad()
def load_state_dict(model: SimCLR, sd: Dict[str, object]) -> SimCLR:
    """Restore an exported checkpoint (fine_tune_from,
    simclr/simclr.py:133-142): positional for the backbone, by name suffix
    for l1/l2."""
    values = [v for k, v in sd.items()
              if not (k.startswith("l1") or k.startswith("l2"))]
    resnet.load_positional(model.backbone, values)
    for key in HEAD_KEYS:
        match = next((v for k, v in sd.items() if k.endswith(key)), None)
        if match is None:
            raise KeyError(key)
        model.get_parameter(key).copy_(resnet._as_tensor(match))
    return model
