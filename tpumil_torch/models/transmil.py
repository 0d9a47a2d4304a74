"""TransMIL, the transformer aggregator of WSI MIL (Shao et al., "TransMIL:
Transformer based Correlated Multiple Instance Learning for Whole Slide
Image Classification", NeurIPS 2021; github.com/szc19990412/TransMIL
``models/TransMIL.py``), with the Nystrom attention of
lucidrains/nystrom-attention (``nystrom_attention.py``).

Per bag (feats ``F [N, K]``), at width D (512), with H = ceil(sqrt(N)):

  1. ``h = ReLU(F W1^T + b1)`` [N, D]; ``h[:H^2 - N]`` appended to ``h``
     (the grid is filled with the bag's first rows) and the learned
     ``cls_token`` put in front: ``x`` [T, D], T = H^2 + 1;
  2. ``x = x + NA(LayerNorm(x))`` (layer 1);
  3. the PPEG: the non-cls rows, row-major, as a grid ``G`` [D, H, H],
     ``G <- dw7(G) + G + dw5(G) + dw3(G)`` (depthwise, with bias, same
     padding), the cls row put back in front;
  4. ``x = x + NA(LayerNorm(x))`` (layer 2);
  5. ``logits = LayerNorm(x)[cls] W2^T + b2`` [C].

NA is Nystrom attention, 8 heads of D / 8, m = 256 landmarks: the normed
rows are padded in front with zero rows to P = m * ceil(T / m);
``q, k, v = x W_qkv^T`` (no bias), ``q <- q / sqrt(D / 8)``; the landmarks
``q~, k~`` are the means of q and k over m groups of P / m consecutive
rows; ``A1 = softmax(q k~^T)``, ``A2 = softmax(q~ k~^T)``,
``A3 = softmax(q~ k^T)``; ``Z`` approximates A2's Moore-Penrose inverse
by 6 iterations from ``Z0 = A2^T / (max row sum * max column sum of
|A2|)`` (maxima over every head):
``Z <- Z/4 (13I - A2 Z (15I - A2 Z (7I - A2 Z)))``; then
``out = (A1 Z)(A3 v) + conv33(v)`` (a depthwise 33-tap convolution along
the rows, one filter a head, no bias), the heads merged, ``W_o``, ``b_o``
and dropout 0.1, and the last T rows kept. Only those rows are computed
past the landmarks here: every op after them is row by row.

Dropout draws its keep masks ``torch.rand(shape, generator=g) >= p`` from
the trainer's generator, layer 1's before layer 2's, scaled by
``1 / (1 - p)``, so that a reference replays them bit for bit. A patch
mask keeps its rows (the reference's row subset). Everything is true f32
(TF32 off). The ``state_dict`` keys are the reference module's
(``cls_token``, ``pos_layer.proj{,1,2}.*``, ``_fc1.0.*``,
``layer{1,2}.{norm,attn.to_qkv,attn.to_out.0,attn.res_conv}.*``,
``norm.*``, ``_fc2.*``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.utils.device import disable_tf32, select_device
from tpumil_torch.utils.prof import span


@dataclasses.dataclass(frozen=True)
class TransMILArch:
    """The published architecture (TransMIL.py, nystrom_attention.py)."""

    dim: int = 512
    heads: int = 8
    landmarks: int = 256
    pinv_iterations: int = 6
    conv_taps: int = 33
    dropout: float = 0.1


# what ``TransMIL(cfg, device)`` builds; the model's own tests shrink it
ARCH = TransMILArch()
PPEG_TAPS = (7, 5, 3)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with each element kept where ``rand >= p`` and scaled by
    ``1 / (1 - p)``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * (keep.to(x.dtype) * (1.0 / (1.0 - p)))


def pinv(x: torch.Tensor, iterations: int) -> torch.Tensor:
    """The iterative Moore-Penrose inverse of ``x [..., m, m]``
    (nystrom_attention.py ``moore_penrose_iter_pinv``)."""
    a = x.abs()
    z = x.transpose(-1, -2) / (a.sum(-1).max() * a.sum(-2).max())
    eye = torch.eye(x.shape[-1], device=x.device, dtype=x.dtype)
    for _ in range(iterations):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - xz @ (15 * eye - xz @ (7 * eye - xz)))
    return z


class NystromAttention(nn.Module):
    def __init__(self, arch: TransMILArch, device):
        super().__init__()
        self.arch = arch
        d = arch.dim
        self.to_qkv = nn.Linear(d, 3 * d, bias=False, device=device)
        # a Sequential for the reference's keys, ``to_out.0.*``
        self.to_out = nn.Sequential(nn.Linear(d, d, device=device))
        self.res_conv = nn.Conv2d(arch.heads, arch.heads,
                                  (arch.conv_taps, 1),
                                  padding=(arch.conv_taps // 2, 0),
                                  groups=arch.heads, bias=False,
                                  device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
        """``x [T, D]`` (normed) -> the attention's output ``[T, D]``."""
        a = self.arch
        h, m = a.heads, a.landmarks
        t = x.shape[0]
        per = -(-t // m)
        p = per * m
        with span("transmil.nystrom"):
            x = F.pad(x, (0, 0, p - t, 0))
            q, k, v = self.to_qkv(x).view(p, 3, h, -1).permute(
                1, 2, 0, 3).unbind(0)                        # [h, P, D/h]
            q = q * q.shape[-1] ** -0.5
            with span("transmil.landmarks"):
                ql = q.reshape(h, m, per, -1).sum(2) / per
                kl = k.reshape(h, m, per, -1).sum(2) / per
                a1 = torch.softmax(q[:, p - t:] @ kl.transpose(1, 2), -1)
                a2 = torch.softmax(ql @ kl.transpose(1, 2), -1)
                a3 = torch.softmax(ql @ k.transpose(1, 2), -1)
            with span("transmil.pinv"):
                z = pinv(a2, a.pinv_iterations)
            out = (a1 @ z) @ (a3 @ v) + self.res_conv(v[None])[0, :, p - t:]
            out = self.to_out(out.transpose(0, 1).reshape(t, -1))
            if self.training:
                out = dropout(out, a.dropout, generator)
            return out


class TransLayer(nn.Module):
    def __init__(self, arch: TransMILArch, device):
        super().__init__()
        self.norm = nn.LayerNorm(arch.dim, device=device)
        self.attn = NystromAttention(arch, device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
        with span("transmil.layer"):
            return x + self.attn(self.norm(x), generator)


class PPEG(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.proj, self.proj1, self.proj2 = (
            nn.Conv2d(dim, dim, k, 1, k // 2, groups=dim, device=device)
            for k in PPEG_TAPS)

    def forward(self, x: torch.Tensor, side: int) -> torch.Tensor:
        with span("transmil.ppeg"):
            d = x.shape[-1]
            g = x[1:].transpose(0, 1).view(1, d, side, side)
            g = self.proj(g) + g + self.proj1(g) + self.proj2(g)
            return torch.cat([x[:1], g.flatten(2)[0].transpose(0, 1)])


class TransMIL(nn.Module):
    """Weights come from a checkpoint (io/torch_ckpt.load_mil_pth) or from
    :func:`init_params`. Built in eval mode; a trainer switches to
    ``train()`` for its steps, where dropout draws from the generator it
    passes. Its objective is the softmax cross-entropy of the bag logits,
    its scores their softmax, and its recipe Lookahead around RAdam
    (train/optim.py); it has no instance stream."""

    objective = "cross_entropy"
    recipe = "lookahead_radam"

    def __init__(self, cfg: DSMILConfig, device: torch.device,
                 arch: Optional[TransMILArch] = None):
        super().__init__()
        arch = arch or ARCH
        if cfg.compute_dtype != torch.float32:
            raise ValueError(f"TransMIL computes in float32, not "
                             f"{cfg.compute_dtype}")
        self.cfg, self.arch = cfg, arch
        self.pos_layer = PPEG(arch.dim, device)
        self._fc1 = nn.Sequential(
            nn.Linear(cfg.feats_size, arch.dim, device=device), nn.ReLU())
        self.cls_token = nn.Parameter(torch.zeros(1, 1, arch.dim,
                                                  device=device))
        self.layer1 = TransLayer(arch, device)
        self.layer2 = TransLayer(arch, device)
        self.norm = nn.LayerNorm(arch.dim, device=device)
        self._fc2 = nn.Linear(arch.dim, cfg.num_classes, device=device)
        self.eval()

    @staticmethod
    def init_params(generator: torch.Generator, cfg: DSMILConfig,
                    device: Optional[torch.device] = None) -> "TransMIL":
        return init_params(generator, cfg, device)

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ins_logits: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None, *,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[None, torch.Tensor, None, None]:
        """feats ``[N, K]`` or one bag ``[1, N, K]``; mask ``[N]`` (or
        ``[1, N]``) bool, True = kept, or None. Returns ``(None,
        bag_logits [C] (or [1, C]), None, None)``: the registry's contract
        with no instance logits, attention or bag embedding."""
        disable_tf32()
        if compute_dtype != torch.float32:
            raise ValueError(f"TransMIL computes in float32, not "
                             f"{compute_dtype}")
        if ins_logits is not None:
            raise ValueError("TransMIL has no instance logits to take")
        batched = feats.dim() == 3
        if batched:
            if feats.shape[0] != 1:
                raise ValueError(f"TransMIL takes one bag at a time, got "
                                 f"{feats.shape[0]}")
            feats = feats[0]
            mask = None if mask is None else mask[0]
        if mask is not None:
            feats = feats[mask]
        with span("transmil.embed"):
            h = self._fc1(feats)
        with span("transmil.pad"):
            n = h.shape[0]
            side = math.isqrt(n - 1) + 1
            x = torch.cat([self.cls_token[0], h, h[:side * side - n]])
        x = self.layer1(x, dropout_generator)
        x = self.pos_layer(x, side)
        x = self.layer2(x, dropout_generator)
        with span("transmil.head"):
            logits = self._fc2(self.norm(x[:1]))
        return None, (logits if batched else logits[0]), None, None


def init_params(generator: torch.Generator, cfg: DSMILConfig,
                device: Optional[torch.device] = None,
                arch: Optional[TransMILArch] = None) -> TransMIL:
    """PyTorch's default initialisation, drawn from ``generator`` (on the
    CPU) in ``state_dict`` order: each weight and bias U(-1/sqrt(fan in),
    1/sqrt(fan in)) of its layer's weight, the layer norms 1 and 0, the
    cls token N(0, 1). ``device`` None is the card (raises without
    one)."""
    model = TransMIL(cfg, select_device("cuda") if device is None else device,
                     arch)
    fan_in = 1
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "cls_token":
                value = torch.randn(p.shape, generator=generator)
            elif name.endswith("norm.weight"):
                value = torch.ones(p.shape)
            elif name.endswith("norm.bias"):
                value = torch.zeros(p.shape)
            else:
                if name.endswith("weight"):
                    fan_in = math.prod(p.shape[1:])
                bound = 1.0 / math.sqrt(fan_in)
                value = torch.rand(p.shape, generator=generator) \
                    * (2 * bound) - bound
            p.copy_(value)
    return model
