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
precision. ``forward(..., compute_dtype=torch.bfloat16)`` runs the whole
forward in bf16 as the JAX package's does: feats, every weight and bias
(cast per call; the parameters stay f32, and their gradients flow back
through the casts), the attention scale, the einsums and the softmax.
Bags may be batched ``[B, N, K]`` with a padding mask, or passed
unpadded as ``[N, K]``: the power-of-two padding of the JAX package exists
for XLA's static shapes and is not needed here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpumil_torch.ops.init import orthogonal_torch
from tpumil_torch.ops.masked import masked_argmax, masked_max, masked_softmax
from tpumil_torch.utils.device import disable_tf32, select_device

ATTN_DIM = 128  # the reference hard-codes 128 query dims


@dataclasses.dataclass(frozen=True)
class DSMILConfig:
    feats_size: int
    num_classes: int
    nonlinear: bool = True
    passing_v: bool = False
    dropout_v: float = 0.0
    # dtype of the aggregator forward (trainers pass it to ``forward``);
    # the parameters stay f32
    compute_dtype: torch.dtype = torch.float32


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a scalar that a forward in ``dtype``
    uses as the JAX package's does, where a Python number takes the
    array's dtype."""
    return float(torch.tensor(value, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function. Below f32 it is ``1 / (1 + exp(-x))`` with
    each step rounded to ``x``'s dtype, as ``jax.nn.sigmoid`` is lowered
    (``torch.sigmoid`` rounds once, and differs in ~30% of bf16 values)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def linear(x: torch.Tensor, layer: nn.Module, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer`` (a Linear) applied in ``dtype``: its weight and bias are
    cast per call, so the parameters stay f32. Below f32 the product is
    rounded before the bias is added, as the JAX package's ``_linear``
    rounds it (``F.linear`` would add the bias before its one rounding)."""
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if dtype == torch.float32:
        return F.linear(x, w, b)
    return torch.matmul(x, w.T) + b


def max_instance_logits(ins_logits: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max_N`` of the instance stream (instance axis -2)."""
    return masked_max(ins_logits, mask, dim=-2)


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
    """Weights come from a checkpoint (io/torch_ckpt.load_mil_pth), from
    the JAX package's parameters (io/from_jax.dsmil_state_dict) or from
    :func:`init_params` / :func:`torch_default_init_params`. Built in eval
    mode; a trainer switches to ``train()`` for its steps, where value
    dropout (``passing_v`` only) draws from the generator it passes.

    Every registry model (models/registry.py) has this constructor,
    forward contract, ``init_params`` and ``max_instance_logits``."""

    objective = "dual_stream"
    recipe = "adam"
    max_instance_logits = staticmethod(max_instance_logits)

    def __init__(self, cfg: DSMILConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.i_classifier = _IClassifier(cfg.feats_size, cfg.num_classes,
                                         device)
        self.b_classifier = _BClassifier(cfg, device)
        self.eval()

    @staticmethod
    def init_params(generator: torch.Generator, cfg: DSMILConfig,
                    device: Optional[torch.device] = None) -> "DSMIL":
        return init_params(generator, cfg, device)

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ins_logits: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None, *,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """feats ``[B, N, K]`` or ``[N, K]``; mask ``[B, N]`` bool (True =
        real) or None; ins_logits optionally precomputed ``[B, N, C]``.
        Returns ``(ins_logits [B,N,C], bag_logits [B,C], A [B,N,C],
        B [B,C,K])`` in ``compute_dtype``, without the batch dim for 2-D
        input. Attention of padded rows is exactly 0. ``compute_dtype`` is
        not read from ``cfg``: callers that want bf16 pass
        ``cfg.compute_dtype``, as the JAX package's do."""
        disable_tf32()
        dt = compute_dtype
        squeeze = feats.dim() == 2
        if squeeze:
            feats = feats[None]
            mask = None if mask is None else mask[None]
            ins_logits = None if ins_logits is None else ins_logits[None]
        f = feats.to(dt)
        c = ins_logits.to(dt) if ins_logits is not None \
            else self.instance_logits(f, dt)
        q = self.queries(f, dt)                              # [B, N, D]
        v = self._values(f, dropout_generator, dt)           # [B, N, K]
        crit = masked_argmax(c, mask, dim=1)                 # [B, C]
        q_max = torch.gather(q, 1, crit[..., None].expand(-1, -1, q.shape[-1]))
        a_logits = torch.einsum("bnd,bcd->bnc", q, q_max) \
            * in_dtype(1.0 / math.sqrt(ATTN_DIM), dt)
        attn = masked_softmax(a_logits, mask, dim=1)         # [B, N, C]
        bemb = torch.einsum("bnc,bnk->bck", attn, v)         # [B, C, K]
        bag_logits = self.bag_head(bemb, dt)
        if squeeze:
            return c[0], bag_logits[0], attn[0], bemb[0]
        return c, bag_logits, attn, bemb

    def instance_logits(self, f: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``c = f Wi^T + bi`` in ``dtype``."""
        return linear(f, self.i_classifier.fc[0], dtype)

    def queries(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The query stream in ``dtype``: Linear -> ReLU -> Linear -> Tanh
        (nonlinear) or one Linear."""
        q = self.b_classifier.q
        if self.cfg.nonlinear:
            return torch.tanh(linear(torch.relu(linear(x, q[0], dtype)),
                                     q[2], dtype))
        return linear(x, q, dtype)

    def bag_head(self, bemb: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The Conv1d(C, C, K) bag head as a full contraction over
        ``bemb [..., C, K]``, in ``dtype``."""
        fcc = self.b_classifier.fcc
        return torch.einsum("...ck,dck->...d", bemb, fcc.weight.to(dtype)) \
            + fcc.bias.to(dtype)

    def _values(self, f: torch.Tensor, generator: Optional[torch.Generator],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """V = feats, or Dropout -> Linear -> ReLU with ``passing_v``, on
        ``f`` in ``dtype``. The dropout is drawn here from ``generator``
        (in training mode only), not by the module's ``nn.Dropout``, which
        stays for the checkpoint layout; the kept values are divided by
        ``1 - p`` in ``dtype``."""
        if not self.cfg.passing_v:
            return f
        p = self.cfg.dropout_v
        if self.training and p > 0.0:
            if generator is None:
                raise ValueError("value dropout in training mode needs a "
                                 "torch.Generator")
            keep = torch.rand(f.shape, generator=generator,
                              device=f.device) < 1.0 - p
            f = torch.where(keep, f / in_dtype(1.0 - p, dtype), 0.0)
        return torch.relu(linear(f, self.b_classifier.v[1], dtype))


def _set(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value)


def init_params(generator: torch.Generator, cfg: DSMILConfig,
                device: Optional[torch.device] = None) -> DSMIL:
    """Orthogonal weights (``torch.nn.init.orthogonal_`` orientation) and
    zero biases, the reference's init, drawn from ``generator`` (on the
    CPU) in the JAX package's order: i_fc, fcc, q, v. ``device`` None is
    the card (raises without one)."""
    model = DSMIL(cfg, select_device("cuda") if device is None else device)
    bc = model.b_classifier
    q = (bc.q[0], bc.q[2]) if cfg.nonlinear else (bc.q,)
    v = (bc.v[1],) if cfg.passing_v else ()
    for layer in (model.i_classifier.fc[0], bc.fcc, *q, *v):
        _set(layer.weight,
             orthogonal_torch(generator, tuple(layer.weight.shape)))
        _set(layer.bias, torch.zeros_like(layer.bias))
    return model


def torch_default_init_params(generator: torch.Generator, cfg: DSMILConfig,
                              device: Optional[torch.device] = None
                              ) -> DSMIL:
    """``nn.Linear``/``nn.Conv1d``'s default init, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases (what the reference's
    train_mil.py trains with), drawn from ``generator`` (on the CPU).
    ``device`` None is the card (raises without one)."""
    model = DSMIL(cfg, select_device("cuda") if device is None else device)
    for layer in model.modules():
        if isinstance(layer, (nn.Linear, nn.Conv1d)):
            bound = 1.0 / math.sqrt(math.prod(layer.weight.shape[1:]))
            for param in (layer.weight, layer.bias):
                u = torch.rand(param.shape, generator=generator)
                _set(param, (2.0 * u - 1.0) * bound)
    return model


def bag_scores(model: DSMIL, feats: torch.Tensor,
               mask: Optional[torch.Tensor] = None, *,
               average: bool = False,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``sigmoid(bag_logits)``, in ``compute_dtype``; with ``average`` the
    sigmoid of the max instance logit is ADDED, undivided, as the
    reference's train_tcga.py ``--average`` does."""
    c, bag_logits, _, _ = model(feats, mask, compute_dtype=compute_dtype)
    if average:
        return sigmoid(bag_logits) + sigmoid(max_instance_logits(c, mask))
    return sigmoid(bag_logits)
