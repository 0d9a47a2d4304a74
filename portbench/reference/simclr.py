"""Plain PyTorch SimCLR step of the reference's recipe
(simclr/models/resnet_simclr.py:10-20, simclr/loss/nt_xent.py,
simclr/simclr.py:72): two augmented views of each image
(``reference/augment.py``), ResNet18-IN (``reference/resnet.py``) to the
pooled 512 features, the projection ``l2(relu(l1(h)))`` to 256 in f32,
NT-Xent at temperature ``t`` over the 2B normalized projections, and the
gradient of the mean loss.

The gradient is computed in blocks of rows so that a batch of 4096 fits:
every projection first without a graph, then the loss and its gradient
with respect to the projections, then each block again with a graph,
back-propagating its rows of that gradient. The sum over the blocks is the
whole batch's gradient (instance norm couples no two images).

Imports torch alone: nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import augment, resnet

HEAD = ("l1.weight", "l1.bias", "l2.weight", "l2.bias")


def make_params(generator, device, feats: int = 512, out_dim: int = 256
                ) -> Dict[str, torch.Tensor]:
    """Backbone convolutions under ``backbone.<torchvision name>`` and the
    head under ``l1.*``, ``l2.*`` (U(-1/sqrt(512), 1/sqrt(512)), a Linear's
    default), made on ``device``."""
    out = {f"backbone.{k}": v for k, v in
           resnet.make_weights(generator, device).items()}
    lim = 1.0 / math.sqrt(feats)
    shapes = ((feats, feats), (feats,), (out_dim, feats), (out_dim,))
    for name, shape in zip(HEAD, shapes):
        u = torch.rand(shape, generator=generator, device=device)
        out[name] = (u * (2 * lim) - lim).contiguous()
    return out


def normalize(z: torch.Tensor) -> torch.Tensor:
    return z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, t: float) -> torch.Tensor:
    """Mean over the 2B anchors of -sim(i, pair(i))/t + logsumexp over
    every other row of sim(i, j)/t, cosine similarities."""
    z = normalize(torch.cat([z2, z1]))
    sim = z @ z.T / t
    n = z1.shape[0]
    idx = torch.arange(2 * n, device=z.device)
    pos = sim[idx, (idx + n) % (2 * n)]
    sim = sim.masked_fill(torch.eye(2 * n, dtype=torch.bool,
                                    device=z.device), float("-inf"))
    return (torch.logsumexp(sim, dim=1) - pos).mean()


def project(p: Dict[str, torch.Tensor], images_u8: torch.Tensor,
            u: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalized projections of both views of ``images_u8``."""
    v1, v2 = augment.augment_pair_batch(images_u8.float() / 255, u, 224,
                                        dtype)
    backbone = {k[len("backbone."):]: v for k, v in p.items()
                if k.startswith("backbone.")}
    out = []
    for v in (v1, v2):
        h = resnet.forward(backbone, v, dtype)
        z = F.linear(torch.relu(F.linear(h, p["l1.weight"], p["l1.bias"])),
                     p["l2.weight"], p["l2.bias"])
        out.append(normalize(z))
    return out[0], out[1]


def loss_and_grads(p: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                   u: torch.Tensor, t: float, dtype: torch.dtype,
                   block: int) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss of one batch and its gradient, in blocks of ``block``."""
    n = images_u8.shape[0]
    with torch.no_grad():
        zs = [project(p, images_u8[i:i + block], u[:, i:i + block], dtype)
              for i in range(0, n, block)]
    z1 = torch.cat([z[0] for z in zs]).requires_grad_()
    z2 = torch.cat([z[1] for z in zs]).requires_grad_()
    loss = nt_xent(z1, z2, t)
    dz1, dz2 = torch.autograd.grad(loss, (z1, z2))
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    for i in range(0, n, block):
        s = slice(i, i + block)
        a, b = project(leaves, images_u8[s], u[:, s], dtype)
        g = torch.autograd.grad((a, b), list(leaves.values()),
                                (dz1[s], dz2[s]), allow_unused=True)
        for k, gi in zip(leaves, g):
            if gi is not None:
                grads[k] += gi
    return float(loss.detach()), grads
