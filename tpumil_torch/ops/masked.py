"""Masked reductions over the instance axis (counterpart of
tpumil/ops/masked.py).

``mask`` is boolean with True = real instance, shaped like ``x`` or like
``x`` without its trailing feature dim. The sentinel is finite (-1e30):
-inf would turn an all-padding softmax row into 0/0 = NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _fill(x: torch.Tensor, mask: Optional[torch.Tensor], value: float):
    if mask is None:
        return x
    if mask.dim() == x.dim() - 1:
        mask = mask.unsqueeze(-1)
    return torch.where(mask, x, torch.full((), value, dtype=x.dtype,
                                           device=x.device))


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int):
    """Max over ``dim`` ignoring padded entries."""
    return _fill(x, mask, NEG_INF).amax(dim=dim)


def masked_argmax(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int):
    """Index of the max over ``dim`` ignoring padded entries; ties go to the
    lowest index (torch.argmax returns the first maximal value)."""
    return _fill(x, mask, NEG_INF).argmax(dim=dim)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int):
    """Mean over ``dim`` counting only real entries; all-padding slices
    give 0."""
    if mask is None:
        return x.mean(dim=dim)
    if mask.dim() == x.dim() - 1:
        mask = mask.unsqueeze(-1)
    m = mask.expand(x.shape).to(x.dtype)
    return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp_min(1.0)


def masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int):
    """Softmax over ``dim``; padded entries get exactly 0 weight."""
    x = _fill(x, mask, NEG_INF)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    e = _fill(e, mask, 0.0)
    denom = e.sum(dim=dim, keepdim=True)
    return e / denom.clamp_min(torch.finfo(e.dtype).tiny)
