"""Optimizer of the reference's training recipe (counterpart of
tpumil/train/optim.py).

``torch.optim.Adam(lr, betas=(0.5, 0.9), weight_decay=wd, eps=1e-8)``: the
weight decay is an L2 term added to the gradient before the moment updates,
the same update as the JAX package's ``add_decayed_weights ->
scale_by_adam``. The cosine schedule is evaluated per epoch and written into
the optimizer's ``param_groups`` (:func:`set_lr`), so one optimizer serves
every epoch.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def adam_torch(params: Iterable[torch.Tensor], betas=(0.5, 0.9),
               weight_decay: float = 0.0, eps: float = 1e-8
               ) -> torch.optim.Adam:
    """The learning rate is set per epoch with :func:`set_lr`."""
    return torch.optim.Adam(params, betas=betas, eps=eps,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0):
    """Per-epoch LR of ``torch.optim.lr_scheduler.CosineAnnealingLR``:
    epoch ``e`` (0-based, scheduler stepped after each epoch) runs at
    ``eta_min + (base_lr - eta_min) * (1 + cos(pi * e / T_max)) / 2``."""

    def lr(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * epoch / t_max)) / 2.0

    return lr
