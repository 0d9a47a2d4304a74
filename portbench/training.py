"""What the training cells' checks share: the readings of the first three
steps (each loss, the first gradient as Adam holds it, the parameters'
change, leaf by leaf) and the numbers compared from them."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import harness
from portbench.reference import compare as cmp


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def first_gradient_norms(opt: torch.optim.Optimizer, named: dict,
                         beta1: float) -> Dict[str, float]:
    """Each leaf's first gradient, as the optimizer got it, from Adam's
    first moment after one step (``(1 - beta1) g``); an optimizer that
    kept no moment holds no gradient."""
    return leaf_norms({n: opt.state.get(p, {}).get("exp_avg", torch.zeros(()))
                       / (1.0 - beta1) for n, p in named.items()})


def compared(limits: dict, observed: dict, readings: dict
             ) -> List[harness.Compared]:
    """The worst step's relative loss gap, and the worst leaf's gaps of
    the first gradient's norms and of the change's norms (leaves whose
    reference gradient is nought to rounding left out of the change)."""
    moving = cmp.moving_leaves(readings["grad1"])
    return [
        harness.Compared("loss_gap", cmp.worst_relative(
            observed["loss"], readings["loss"]), limits["loss_gap"]),
        harness.Compared("grad1_gap", cmp.worst_leaf_gap(
            observed["grad1"], readings["grad1"]), limits["grad1_gap"]),
        harness.Compared("delta3_gap", cmp.worst_leaf_gap(
            observed["delta"], readings["delta"], moving),
            limits["delta3_gap"]),
    ]
