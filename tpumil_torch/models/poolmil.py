"""Max- and mean-pooling MIL baselines (counterpart of
tpumil/models/poolmil.py).

The DSMIL paper's benchmark tables compare against classic max- and
mean-pooling MIL; the reference ships no code for them. The forward
contract is ``DSMIL``'s, so the trainers, schemes and the server take them
through ``--model meanpool|maxpool``:

  per bag (feats [N, K]):
    instance logits  c = feats @ Wi^T + bi          [N, C]
    bag logits       mean_N(c)   (meanpool)         [C]
                     max_N(c)    (maxpool)
    attention A      the implied pooling weights: uniform over real rows
                     (meanpool) or one-hot at the per-class argmax, the
                     first maximum on ties (maxpool)
    bag embedding    B = A^T feats                  [C, K]

The ``state_dict`` is the JAX package's pooling ``.pth`` schema: the
``i_classifier.fc.*`` head and ``pooling.mode``, a 0-d f32 buffer (0.0 for
mean, 1.0 for max) that no optimizer sees. The trainers apply the
dual-stream objective to every model; for maxpool its two terms coincide.
With ``compute_dtype=torch.bfloat16`` the forward runs in bf16, the pooling
weights built in the logits' dtype, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tpumil_torch.models.abmil import InstanceClassifier
from tpumil_torch.models.dsmil import (DSMILConfig, _set, linear,
                                       max_instance_logits)
from tpumil_torch.ops.init import orthogonal_torch
from tpumil_torch.ops.masked import masked_argmax, masked_max, masked_mean
from tpumil_torch.utils.device import disable_tf32, select_device


class _Pooling(nn.Module):
    def __init__(self, mode: float, device):
        super().__init__()
        self.register_buffer("mode", torch.tensor(mode, device=device))


class _PoolMIL(nn.Module):
    """Weights come from a checkpoint (io/torch_ckpt.load_mil_pth), from
    the JAX package's parameters (io/from_jax.poolmil_state_dict) or from
    :meth:`init_params`. Built in eval mode."""

    MODE: float
    objective = "dual_stream"
    recipe = "adam"
    max_instance_logits = staticmethod(max_instance_logits)

    def __init__(self, cfg: DSMILConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.i_classifier = InstanceClassifier(cfg.feats_size,
                                               cfg.num_classes, device)
        self.pooling = _Pooling(self.MODE, device)
        self.eval()

    @classmethod
    def init_params(cls, generator: torch.Generator, cfg: DSMILConfig,
                    device: Optional[torch.device] = None) -> "_PoolMIL":
        """An orthogonal instance head with a zero bias, drawn from
        ``generator`` (on the CPU). ``device`` None is the card (raises
        without one)."""
        model = cls(cfg, select_device("cuda") if device is None else device)
        fc = model.i_classifier.fc
        _set(fc.weight, orthogonal_torch(generator, tuple(fc.weight.shape)))
        _set(fc.bias, torch.zeros_like(fc.bias))
        return model

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ins_logits: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None, *,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """As ``DSMIL.forward``: ``(ins_logits, bag_logits, A, B)`` in
        ``compute_dtype``, without the batch dim for 2-D input.
        ``dropout_generator`` is accepted for the trainer and ignored."""
        disable_tf32()
        dt = compute_dtype
        squeeze = feats.dim() == 2
        if squeeze:
            feats = feats[None]
            mask = None if mask is None else mask[None]
            ins_logits = None if ins_logits is None else ins_logits[None]
        f = feats.to(dt)
        c = ins_logits.to(dt) if ins_logits is not None \
            else linear(f, self.i_classifier.fc, dt)                # [B, N, C]
        bag_logits, attn = self._pool(c, mask)
        bemb = torch.einsum("bnc,bnk->bck", attn, f)                # [B, C, K]
        if squeeze:
            return c[0], bag_logits[0], attn[0], bemb[0]
        return c, bag_logits, attn, bemb


class MeanPool(_PoolMIL):
    MODE = 0.0

    @staticmethod
    def _pool(c, mask):
        if mask is None:
            attn = torch.full_like(c, 1.0 / c.shape[1])
        else:
            m = mask.to(c.dtype)[..., None]                         # [B, N, 1]
            attn = (m / m.sum(dim=1, keepdim=True).clamp_min(1.0)).expand(
                c.shape)
        return masked_mean(c, mask, dim=1), attn


class MaxPool(_PoolMIL):
    MODE = 1.0

    @staticmethod
    def _pool(c, mask):
        idx = masked_argmax(c, mask, dim=1)                         # [B, C]
        attn = torch.nn.functional.one_hot(idx, c.shape[1]).to(
            c.dtype).transpose(1, 2)                                # [B, N, C]
        return masked_max(c, mask, dim=1), attn
