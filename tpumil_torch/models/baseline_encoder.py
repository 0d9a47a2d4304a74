"""Baseline 4-conv encoder with a projection head (counterpart of
tpumil/models/baseline_encoder.py).

The reference's (unused) simclr/models/baseline_encoder.py:7-43: a small CNN
alternative to the ResNet backbone for SimCLR experiments, 4 x (conv3x3 +
bias -> ReLU -> maxpool 2), a mean pool, then a 2-layer projection MLP.
Returns ``(h, z)`` like ``models/simclr.SimCLR``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpumil_torch.utils.device import disable_tf32

WIDTHS = (32, 64, 128, 256)


class BaselineEncoder(nn.Module):
    """Convs ``conv0``..``conv3`` (OIHW weights, biases), head ``l1``,
    ``l2``; activations in ``compute_dtype``, the head in f32."""

    def __init__(self, device: torch.device, out_dim: int = 256,
                 feat_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        in_ch = 3
        for i, w in enumerate(WIDTHS):
            setattr(self, f"conv{i}", nn.Conv2d(in_ch, w, 3, padding=1,
                                                device=device))
            in_ch = w
        self.l1 = nn.Linear(feat_dim, feat_dim, device=device)
        self.l2 = nn.Linear(feat_dim, out_dim, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "BaselineEncoder":
        """Conv weights N(0, 2 / (9 * out channels)), linear weights
        U(-1/sqrt(feat_dim), 1/sqrt(feat_dim)), every bias zero (the JAX
        package's init), drawn on the CPU from ``generator``."""
        for i, w in enumerate(WIDTHS):
            conv = getattr(self, f"conv{i}")
            std = float(np.sqrt(2.0 / (3 * 3 * w)))
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator) * std)
            conv.bias.zero_()
        lim = 1.0 / np.sqrt(self.l1.in_features)
        for lin in (self.l1, self.l2):
            u = torch.rand(lin.weight.shape, generator=generator)
            lin.weight.copy_(u * (2 * lim) - lim)
            lin.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, H, W, 3] -> (h [B, 256] f32, z [B, out_dim] f32)."""
        disable_tf32()
        dt = self.compute_dtype
        h = x.permute(0, 3, 1, 2).to(dt)
        for i in range(len(WIDTHS)):
            conv = getattr(self, f"conv{i}")
            h = F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            h = F.max_pool2d(torch.relu(h), kernel_size=2, stride=2)
        h = h.mean(dim=(2, 3)).float()
        z = F.linear(torch.relu(F.linear(h, self.l1.weight, self.l1.bias)),
                     self.l2.weight, self.l2.bias)
        return h, z
