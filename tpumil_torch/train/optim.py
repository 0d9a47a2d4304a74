"""Optimizer of the reference's training recipe (counterpart of
tpumil/train/optim.py).

``torch.optim.Adam(lr, betas=(0.5, 0.9), weight_decay=wd, eps=1e-8)``: the
weight decay is an L2 term added to the gradient before the moment updates,
the same update as the JAX package's ``add_decayed_weights ->
scale_by_adam``. The cosine schedule is evaluated per epoch and written into
the optimizer's ``param_groups`` (:func:`set_lr`), so one optimizer serves
every epoch.

TransMIL's recipe (its repo's ``Camelyon/TransMIL.yaml``: timm's
``lookahead_radam``, lr 2e-4, weight decay 1e-5) is :func:`lookahead_radam`:
``torch.optim.RAdam`` with decoupled weight decay inside a
:class:`Lookahead`.
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


class Lookahead:
    """Lookahead (Zhang et al. 2019) around ``base``: every ``k`` steps the
    slow weights move ``alpha`` of the way to the fast ones, and the fast
    weights take their value. The slow weights start at the parameters'
    values when it is built. ``param_groups`` and ``state`` are the base
    optimizer's, so :func:`set_lr` and a reader of its moments see
    through it."""

    def __init__(self, base: torch.optim.Optimizer, k: int = 6,
                 alpha: float = 0.5):
        self.base, self.k, self.alpha = base, k, alpha
        self.param_groups = base.param_groups
        self.params = [p for g in base.param_groups for p in g["params"]]
        self.slow = [p.detach().clone() for p in self.params]
        self.steps = 0

    @property
    def state(self):
        return self.base.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.base.step()
        self.steps += 1
        if self.steps % self.k == 0:
            torch._foreach_lerp_(self.slow, self.params, self.alpha)
            torch._foreach_copy_(self.params, self.slow)

    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(), "steps": self.steps,
                "slow": [s.clone() for s in self.slow]}

    def load_state_dict(self, sd: dict) -> None:
        self.base.load_state_dict(sd["base"])
        self.steps = int(sd["steps"])
        for s, v in zip(self.slow, sd["slow"]):
            s.copy_(v)


def lookahead_radam(params: Iterable[torch.Tensor], weight_decay: float = 0.0,
                    betas=(0.9, 0.999), eps: float = 1e-8, k: int = 6,
                    alpha: float = 0.5) -> Lookahead:
    """Lookahead(k, alpha) around RAdam with decoupled weight decay (each
    step first scales the parameters by ``1 - lr * weight_decay``). The
    learning rate is set per epoch with :func:`set_lr`."""
    return Lookahead(torch.optim.RAdam(params, betas=betas, eps=eps,
                                       weight_decay=weight_decay,
                                       decoupled_weight_decay=True), k, alpha)


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
