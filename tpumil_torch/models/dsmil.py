"""Dual-stream MIL aggregator, DSMIL (counterpart of
tpumil/models/dsmil.py).

The module's ``state_dict`` keys are the reference schema
(io/torch_ckpt.py), so shipped ``.pth`` files load with ``strict=True``.

Math per bag, given instance features ``feats in R^{N x K}``:

  1. instance logits   c = feats @ Wi^T + bi                      [N, C]
  2. queries           Q = q(feats)                               [N, D] (D=128)
  3. values            V = feats (default) or ReLU(Linear(feats)) [N, K]
  4. critical query    q_max = Q[argmax_N c]                      [C, D]
  5. attention         A = softmax_N(Q @ q_max^T / sqrt(D))       [N, C]
  6. bag embedding     B = A^T V                                  [C, K]
  7. bag logits        out_d = sum_{c,k} Wf[d,c,k] * B[c,k] + bf  [C]

Every matmul is true f32 (TF32 off), like the JAX package's HIGHEST
precision. Bags may be batched ``[B, N, K]`` with a padding mask, or passed
unpadded as ``[N, K]``: the power-of-two padding of the JAX package exists
for XLA's static shapes and is not needed here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from tpumil_torch.ops.masked import masked_argmax, masked_max, masked_softmax
from tpumil_torch.utils.device import disable_tf32

ATTN_DIM = 128  # the reference hard-codes 128 query dims


@dataclasses.dataclass(frozen=True)
class DSMILConfig:
    feats_size: int
    num_classes: int
    nonlinear: bool = True
    passing_v: bool = False
    dropout_v: float = 0.0


class _IClassifier(nn.Module):
    def __init__(self, k: int, c: int, device):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(k, c, device=device))


class _BClassifier(nn.Module):
    def __init__(self, cfg: DSMILConfig, device):
        super().__init__()
        k, c = cfg.feats_size, cfg.num_classes
        if cfg.nonlinear:
            self.q = nn.Sequential(nn.Linear(k, ATTN_DIM, device=device),
                                   nn.ReLU(),
                                   nn.Linear(ATTN_DIM, ATTN_DIM, device=device),
                                   nn.Tanh())
        else:
            self.q = nn.Linear(k, ATTN_DIM, device=device)
        if cfg.passing_v:
            self.v = nn.Sequential(nn.Dropout(cfg.dropout_v),
                                   nn.Linear(k, k, device=device), nn.ReLU())
        else:
            self.v = nn.Identity()
        # the reference's Conv1d(C, C, kernel_size=K) bag head; applied as
        # a full contraction
        self.fcc = nn.Conv1d(c, c, kernel_size=k, device=device)


class DSMIL(nn.Module):
    """Weights come from a checkpoint (io/torch_ckpt.load_mil_pth) or from
    the JAX package's parameters (io/from_jax.dsmil_state_dict)."""

    def __init__(self, cfg: DSMILConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.i_classifier = _IClassifier(cfg.feats_size, cfg.num_classes,
                                         device)
        self.b_classifier = _BClassifier(cfg, device)
        self.eval()  # inference slice: value dropout stays off

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ins_logits: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """feats ``[B, N, K]`` or ``[N, K]``; mask ``[B, N]`` bool (True =
        real) or None; ins_logits optionally precomputed ``[B, N, C]``.
        Returns ``(ins_logits [B,N,C], bag_logits [B,C], A [B,N,C],
        B [B,C,K])``, without the batch dim for 2-D input. Attention of
        padded rows is exactly 0."""
        disable_tf32()
        squeeze = feats.dim() == 2
        if squeeze:
            feats = feats[None]
            mask = None if mask is None else mask[None]
            ins_logits = None if ins_logits is None else ins_logits[None]
        f = feats.float()
        c = ins_logits.float() if ins_logits is not None \
            else self.i_classifier.fc(f)
        bc = self.b_classifier
        q = bc.q(f)                                          # [B, N, D]
        v = bc.v(f)                                          # [B, N, K]
        crit = masked_argmax(c, mask, dim=1)                 # [B, C]
        q_max = torch.gather(q, 1, crit[..., None].expand(-1, -1, q.shape[-1]))
        a_logits = torch.einsum("bnd,bcd->bnc", q, q_max) \
            * (1.0 / math.sqrt(ATTN_DIM))
        attn = masked_softmax(a_logits, mask, dim=1)         # [B, N, C]
        bemb = torch.einsum("bnc,bnk->bck", attn, v)         # [B, C, K]
        bag_logits = torch.einsum("bck,dck->bd", bemb, bc.fcc.weight) \
            + bc.fcc.bias
        if squeeze:
            return c[0], bag_logits[0], attn[0], bemb[0]
        return c, bag_logits, attn, bemb


def max_instance_logits(ins_logits: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max_N`` of the instance stream (instance axis -2)."""
    return masked_max(ins_logits, mask, dim=-2)


def bag_scores(model: DSMIL, feats: torch.Tensor,
               mask: Optional[torch.Tensor] = None, *,
               average: bool = False) -> torch.Tensor:
    """``sigmoid(bag_logits)``; with ``average`` the sigmoid of the max
    instance logit is ADDED, undivided, as the reference's train_tcga.py
    ``--average`` does."""
    c, bag_logits, _, _ = model(feats, mask)
    if average:
        return torch.sigmoid(bag_logits) + \
            torch.sigmoid(max_instance_logits(c, mask))
    return torch.sigmoid(bag_logits)
