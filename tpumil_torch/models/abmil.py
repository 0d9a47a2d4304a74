"""Gated attention-based MIL, ABMIL (counterpart of tpumil/models/abmil.py).

The reference selects it with ``--model abmil`` (train_tcga.py:226-227,
train_mil.py:124-125) but ships no abmil.py. This is the gated attention of
Ilse et al. 2018, with the forward contract of ``DSMIL`` so that the
trainers, schemes and the server take either:

  per bag (feats [N, K]):
    instance logits  c = feats @ Wi^T + bi                       [N, C]
    gate             A_n = w^T (tanh(Wv f_n) * sigmoid(Wu f_n))  [N, 1]
    attention        A = softmax_N(A_n)  (broadcast to [N, C])
    bag embedding    B = A^T feats                               [1, K] -> [C, K]
    bag logits       out = B @ Wb^T + bb                         [C]

The module's ``state_dict`` keys are the JAX package's ABMIL ``.pth``
schema (``i_classifier.fc.*``, ``b_classifier.attention_{v,u,w}.*``,
``b_classifier.fc.*``). Every matmul is true f32 (TF32 off); with
``compute_dtype=torch.bfloat16`` the forward runs in bf16, the weights cast
per call, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tpumil_torch.models.dsmil import (DSMILConfig, _set, linear,
                                       max_instance_logits, sigmoid)
from tpumil_torch.ops.init import orthogonal_torch
from tpumil_torch.ops.masked import masked_softmax
from tpumil_torch.utils.device import disable_tf32, select_device

# ABMIL's own gated-attention width (Ilse et al. 2018 use L = 128 for the
# small datasets), independent of dsmil.ATTN_DIM, which happens to share
# the value: changing one must not change the other's checkpoints.
ATTN_DIM = 128


class InstanceClassifier(nn.Module):
    """The instance head ``i_classifier.fc``: one Linear, no Sequential (the
    ABMIL and pooling schemas; DSMIL's is ``fc.0``)."""

    def __init__(self, k: int, c: int, device):
        super().__init__()
        self.fc = nn.Linear(k, c, device=device)


class _Attention(nn.Module):
    def __init__(self, k: int, c: int, device):
        super().__init__()
        self.attention_v = nn.Linear(k, ATTN_DIM, device=device)
        self.attention_u = nn.Linear(k, ATTN_DIM, device=device)
        self.attention_w = nn.Linear(ATTN_DIM, 1, device=device)
        self.fc = nn.Linear(k, c, device=device)


class ABMIL(nn.Module):
    """Weights come from a checkpoint (io/torch_ckpt.load_mil_pth), from
    the JAX package's parameters (io/from_jax.abmil_state_dict) or from
    :func:`init_params`. Built in eval mode."""

    objective = "dual_stream"
    recipe = "adam"
    max_instance_logits = staticmethod(max_instance_logits)

    def __init__(self, cfg: DSMILConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.i_classifier = InstanceClassifier(cfg.feats_size,
                                               cfg.num_classes, device)
        self.b_classifier = _Attention(cfg.feats_size, cfg.num_classes,
                                       device)
        self.eval()

    @staticmethod
    def init_params(generator: torch.Generator, cfg: DSMILConfig,
                    device: Optional[torch.device] = None) -> "ABMIL":
        return init_params(generator, cfg, device)

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ins_logits: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None, *,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """feats ``[B, N, K]`` or ``[N, K]``; mask ``[B, N]`` bool (True =
        real) or None; ins_logits optionally precomputed ``[B, N, C]``.
        Returns ``(ins_logits [B,N,C], bag_logits [B,C], A [B,N,C],
        B [B,C,K])`` in ``compute_dtype``, as ``DSMIL`` does: the one
        attention head broadcast per class. ``dropout_generator`` is
        accepted for the trainer and ignored (no value stream here)."""
        disable_tf32()
        dt = compute_dtype
        squeeze = feats.dim() == 2
        if squeeze:
            feats = feats[None]
            mask = None if mask is None else mask[None]
            ins_logits = None if ins_logits is None else ins_logits[None]
        f = feats.to(dt)
        c = ins_logits.to(dt) if ins_logits is not None \
            else linear(f, self.i_classifier.fc, dt)
        bc = self.b_classifier
        gate = linear(torch.tanh(linear(f, bc.attention_v, dt))
                      * sigmoid(linear(f, bc.attention_u, dt)),
                      bc.attention_w, dt)                           # [B, N, 1]
        attn1 = masked_softmax(gate, mask, dim=1)
        bemb1 = torch.einsum("bno,bnk->bok", attn1, f)              # [B, 1, K]
        bag_logits = linear(bemb1[:, 0, :], bc.fc, dt)              # [B, C]
        num_classes = c.shape[-1]
        attn = attn1.expand(-1, -1, num_classes)
        bemb = bemb1.expand(-1, num_classes, -1)
        if squeeze:
            return c[0], bag_logits[0], attn[0], bemb[0]
        return c, bag_logits, attn, bemb


def init_params(generator: torch.Generator, cfg: DSMILConfig,
                device: Optional[torch.device] = None) -> ABMIL:
    """Orthogonal weights and zero biases, drawn from ``generator`` (on the
    CPU) in the JAX package's order: i_fc, att_v, att_u, att_w, bag_fc.
    ``device`` None is the card (raises without one)."""
    model = ABMIL(cfg, select_device("cuda") if device is None else device)
    bc = model.b_classifier
    for layer in (model.i_classifier.fc, bc.attention_v, bc.attention_u,
                  bc.attention_w, bc.fc):
        _set(layer.weight,
             orthogonal_torch(generator, tuple(layer.weight.shape)))
        _set(layer.bias, torch.zeros_like(layer.bias))
    return model
