"""Plain PyTorch DSMIL (Li, Li & Eliceiri, CVPR 2021; the reference's
dsmil.py) with its training objective and the Adam step of its recipe.

Parameters are a dict under the reference's state_dict names. For a bag
``f [N, K]`` with C classes and query width D:

    c     = f Wi^T + bi                       instance logits   [N, C]
    Q     = tanh(relu(f W0^T + b0) W2^T + b2) queries           [N, D]
    q_max = Q[argmax_N c]                     critical queries  [C, D]
    A     = softmax_N(Q q_max^T / sqrt(D))                      [N, C]
    B     = A^T f                             bag embedding     [C, K]
    y_bag = sum_{c,k} Wf[:, c, k] B[c, k] + bf                  [C]
    loss  = BCE(y_bag, y) / 2 + BCE(max_N c, y) / 2

Imports torch alone: nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

NAMES = ("i_classifier.fc.0.weight", "i_classifier.fc.0.bias",
         "b_classifier.q.0.weight", "b_classifier.q.0.bias",
         "b_classifier.q.2.weight", "b_classifier.q.2.bias",
         "b_classifier.fcc.weight", "b_classifier.fcc.bias")


def make_params(k: int, c: int, d: int, generator, device
                ) -> Dict[str, torch.Tensor]:
    """Seeded weights (normal, std 1/sqrt(fan in)) and biases (normal, std
    0.1), in one draw on ``device``."""
    shapes = {NAMES[0]: (c, k), NAMES[1]: (c,), NAMES[2]: (d, k),
              NAMES[3]: (d,), NAMES[4]: (d, d), NAMES[5]: (d,),
              NAMES[6]: (c, c, k), NAMES[7]: (c,)}
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 0
        std = 1.0 / math.sqrt(fan_in) if fan_in else 0.1
        out[name] = (flat[at:at + n] * std).reshape(shape).clone()
        at += n
    return out


def bce_with_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((1.0 - y) * x + F.softplus(-x)).mean()


def loss(p: Dict[str, torch.Tensor], f: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    c = f @ p[NAMES[0]].T + p[NAMES[1]]
    q = torch.tanh(torch.relu(f @ p[NAMES[2]].T + p[NAMES[3]])
                   @ p[NAMES[4]].T + p[NAMES[5]])
    q_max = q[torch.argmax(c, dim=0)]
    a = torch.softmax(q @ q_max.T / math.sqrt(q.shape[1]), dim=0)
    b = a.T @ f
    y_bag = torch.einsum("ck,dck->d", b, p[NAMES[6]]) + p[NAMES[7]]
    return 0.5 * bce_with_logits(y_bag, y) \
        + 0.5 * bce_with_logits(c.max(dim=0).values, y)


class Adam:
    """``torch.optim.Adam``'s update, written out: the weight decay is an
    L2 term added to the gradient before the moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def effective_grads(self, params, grads) -> Dict[str, torch.Tensor]:
        """The gradients as the moments take them (decay added)."""
        return {k: grads[k] + self.wd * params[k] for k in params}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        b1, b2 = self.betas
        g = self.effective_grads(params, grads)
        for k in params:
            self.m[k].mul_(b1).add_(g[k], alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g[k], g[k], value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            params[k].sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
