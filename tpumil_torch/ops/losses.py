"""Losses (counterpart of tpumil/ops/losses.py).

``bce_with_logits`` has ``torch.nn.BCEWithLogitsLoss`` semantics (optional
``pos_weight`` broadcast over the class axis), written out so that it is the
same expression as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None,
                    reduction: str = "mean") -> torch.Tensor:
    """Per element ``(1 - y) x + (1 + (p - 1) y) softplus(-x)``."""
    if reduction not in ("mean", "sum", "none"):
        # a typo ("Mean", "avg") must not silently return the unreduced
        # array where the caller expected a scalar
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', "
                         f"got {reduction!r}")
    logits = logits.float()
    labels = labels.float()
    softplus_neg = F.softplus(-logits)
    if pos_weight is None:
        loss = (1.0 - labels) * logits + softplus_neg
    else:
        loss = (1.0 - labels) * logits \
            + (1.0 + (pos_weight - 1.0) * labels) * softplus_neg
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def dual_stream_loss(bag_logits: torch.Tensor, max_ins_logits: torch.Tensor,
                     labels: torch.Tensor,
                     pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DSMIL objective ``0.5 BCE(bag, y) + 0.5 BCE(max instance, y)``."""
    return 0.5 * bce_with_logits(bag_logits, labels, pos_weight) \
        + 0.5 * bce_with_logits(max_ins_logits, labels, pos_weight)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       pos_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """TransMIL's objective on a bag's logits ``[C]``: the softmax
    cross-entropy against the bag's class, the largest entry of its label
    ``[C]`` (one-hot; no host sync). One logit ``x`` is a two-class softmax
    over ``(0, x)``, which is BCE, and takes ``pos_weight`` as BCE does;
    with more, ``pos_weight`` is refused."""
    if logits.shape[-1] == 1:
        return bce_with_logits(logits, labels, pos_weight)
    if pos_weight is not None:
        raise ValueError("pos_weight weights a binary objective; the "
                         "softmax cross-entropy over C > 1 classes takes "
                         "none")
    return F.cross_entropy(logits.float()[None], labels.argmax(-1)[None])


def class_scores(logits: torch.Tensor) -> torch.Tensor:
    """The scores of :func:`cross_entropy_loss`'s logits: their softmax,
    or, for one logit, its sigmoid."""
    if logits.shape[-1] == 1:
        return torch.sigmoid(logits)
    return torch.softmax(logits, -1)
