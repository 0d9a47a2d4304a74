"""Patch embedder: ResNet backbone + per-instance linear head (counterpart
of tpumil/models/embedder.py).

The reference's ``IClassifier(resnet, feats_size, num_classes)`` wraps the
frozen CNN (``feature_extractor``) and a Linear head (``fc``), returning
``(feats, instance_logits)``; ``Embedder`` keeps those submodule names.
SimCLR checkpoints load by the reference's surgery: the last four entries
(projection MLP) are dropped and the rest assigned positionally onto the
backbone's parameter order.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpumil_torch.models import resnet
from tpumil_torch.models.resnet import ResNetConfig

BACKBONE_DEPTH = {"resnet18": 18, "resnet34": 34, "resnet50": 50,
                  "resnet101": 101}

# --precision flag -> activation dtype. The one table that maps the JAX
# package's tiers onto the card. f32 / f32h / f32x are all true f32: the
# shipped aggregator thresholds come from f32 torch inference, and TF32 keeps
# ~3 decimal digits, so every forward turns TF32 off for cuDNN and matmul
# (utils/device.disable_tf32). bf16 keeps activations in bf16 (norm
# statistics stay f32). No TF32 tier exists.
PRECISION_FLAGS = {
    "bf16": torch.bfloat16,
    "f32": torch.float32,
    "f32h": torch.float32,
    "f32x": torch.float32,
}


def precision_from_flag(flag: str) -> torch.dtype:
    try:
        return PRECISION_FLAGS[flag]
    except KeyError:
        raise ValueError(f"unknown precision flag {flag!r}; "
                         f"expected one of {sorted(PRECISION_FLAGS)}") from None


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    backbone: str = "resnet18"
    norm: str = "instance"
    num_classes: int = 2
    precision: str = "f32"     # a PRECISION_FLAGS key
    space_to_depth: bool = False

    @property
    def resnet_cfg(self) -> ResNetConfig:
        return ResNetConfig(depth=BACKBONE_DEPTH[self.backbone], norm=self.norm,
                            compute_dtype=precision_from_flag(self.precision),
                            space_to_depth=self.space_to_depth)

    @property
    def num_feats(self) -> int:
        return self.resnet_cfg.num_feats


class Embedder(nn.Module):
    def __init__(self, cfg: EmbedderConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.feature_extractor = resnet.ResNet(cfg.resnet_cfg, device)
        # the head is zeros until set_head: untrained in the reference too
        self.fc = nn.Linear(cfg.num_feats, cfg.num_classes, device=device)
        self.set_head(np.zeros((cfg.num_classes, cfg.num_feats), np.float32),
                      np.zeros((cfg.num_classes,), np.float32))
        self.requires_grad_(False)

    @torch.no_grad()
    def set_head(self, w, b) -> "Embedder":
        """Install the instance head from an aggregator checkpoint (the
        reference's attention_map.py copies i_classifier.fc.0.*)."""
        self.fc.weight.copy_(torch.as_tensor(w, dtype=torch.float32))
        self.fc.bias.copy_(torch.as_tensor(b, dtype=torch.float32))
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [N, H, W, 3] float in [0, 1], or uint8 in [0, 255] (copied to
        the device as uint8 and divided by 255 there: 4x fewer bytes over
        the bus). Returns (feats [N, K] f32, logits [N, C] f32)."""
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        feats = self.feature_extractor(x)
        return feats, F.linear(feats, self.fc.weight, self.fc.bias)


def init_params(seed: int, cfg: EmbedderConfig,
                device: torch.device) -> Embedder:
    """A seeded random-init embedder: the backbone from a CPU
    ``torch.Generator`` (same weights on every device), a zero head."""
    model = Embedder(cfg, device)
    model.feature_extractor.init_params(torch.Generator().manual_seed(seed))
    return model


def load_simclr_checkpoint(path: str, cfg: EmbedderConfig, device: torch.device,
                           strip_head: Optional[bool] = None) -> Embedder:
    """Load a SimCLR ``model.pth`` (or a surgered ``embedder*.pth``) by the
    positional surgery; the head is zero.

    ``strip_head=None`` detects the layout: exactly 4 tensors beyond the
    backbone's count is a raw SimCLR checkpoint (projection MLP stripped),
    exactly the backbone's count is a surgered export, anything else is an
    error. Torchvision-style batch-norm checkpoints (with
    num_batches_tracked entries) load by name."""
    from tpumil_torch.io import torch_ckpt

    sd = torch_ckpt.load_state_dict(path)
    model = Embedder(cfg, device)
    backbone = model.feature_extractor
    if any(k.endswith("num_batches_tracked") for k in sd):
        resnet.load_torch_state_dict(backbone, sd)
        return model
    n_params = len(resnet.param_names(cfg.resnet_cfg))
    if strip_head is None:
        surplus = len(sd) - n_params
        if surplus not in (0, 4):
            raise ValueError(
                f"checkpoint {path} has {len(sd)} tensors; expected exactly "
                f"the {n_params} backbone tensors (surgered export) or "
                f"{n_params + 4} (raw SimCLR with projection MLP)")
        strip_head = surplus == 4
    if strip_head:
        sd = torch_ckpt.strip_projection_head(sd)
    resnet.load_positional(backbone, list(sd.values())[:n_params])
    return model


def export_embedder_state_dict(model: Embedder) -> "collections.OrderedDict":
    """The reference's embedder.pth layout: ``feature_extractor.<torchvision
    name>`` in order."""
    return resnet.export_state_dict(model.feature_extractor,
                                    prefix="feature_extractor.")
