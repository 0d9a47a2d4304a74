"""Plain PyTorch TransMIL (Shao et al., NeurIPS 2021; github.com/szc19990412/
TransMIL models/TransMIL.py, with lucidrains/nystrom-attention's
nystrom_attention.py), its cross-entropy objective, and the update of its
recipe, Lookahead around RAdam, written out.

Parameters are a dict under the reference module's state_dict names. For a
bag ``f [N, K]``, width D, H = ceil(sqrt(N)):

    h      = relu(f W1^T + b1); h = [h; h[:H^2 - N]]; x = [cls; h]  [T, D]
    x      = x + NA(LN1(x))                                 layer 1
    G      = x[1:]^T as [D, H, H]; G = dw7(G) + G + dw5(G) + dw3(G)
    x      = [x[0]; G as rows]                              the PPEG
    x      = x + NA(LN2(x))                                 layer 2
    logits = LN(x)[0] W2^T + b2                             [C]
    loss   = cross-entropy(logits, argmax y)

NA: zero rows in front up to P = m ceil(T / m); q, k, v = x Wqkv^T in
heads; q / sqrt(D / heads); landmarks the means of m groups of P / m rows;
A1 = softmax(q k~^T), A2 = softmax(q~ k~^T), A3 = softmax(q~ k^T); Z the
iterative pseudo-inverse of A2; (A1 Z)(A3 v) + conv33(v); heads merged,
Wo, bo; the last T rows, then dropout (keep where rand >= p, drawn from
the generator for those rows, layer 1 first; scaled by 1 / (1 - p)).

Every product is computed at full length, as the published code does. The
forward sets both TF32 switches to ``tf32`` (False: true f32). Imports
torch alone: nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

PPEG = (("proj", 7), ("proj1", 5), ("proj2", 3))


def shapes(k: int, c: int, dim: int = 512, heads: int = 8,
           taps: int = 33) -> Dict[str, tuple]:
    """Every parameter's shape, in state_dict order."""
    out = {"cls_token": (1, 1, dim)}
    for name, size in PPEG:
        out[f"pos_layer.{name}.weight"] = (dim, 1, size, size)
        out[f"pos_layer.{name}.bias"] = (dim,)
    out["_fc1.0.weight"], out["_fc1.0.bias"] = (dim, k), (dim,)
    for layer in ("layer1", "layer2"):
        out[f"{layer}.norm.weight"] = (dim,)
        out[f"{layer}.norm.bias"] = (dim,)
        out[f"{layer}.attn.to_qkv.weight"] = (3 * dim, dim)
        out[f"{layer}.attn.to_out.0.weight"] = (dim, dim)
        out[f"{layer}.attn.to_out.0.bias"] = (dim,)
        out[f"{layer}.attn.res_conv.weight"] = (heads, 1, taps, 1)
    out["norm.weight"], out["norm.bias"] = (dim,), (dim,)
    out["_fc2.weight"], out["_fc2.bias"] = (c, dim), (c,)
    return out


def make_params(k: int, c: int, generator, device, dim: int = 512,
                heads: int = 8, taps: int = 33) -> Dict[str, torch.Tensor]:
    """Seeded parameters in one normal draw on ``device``: weights with
    std 1/sqrt(fan in), biases 0.1, layer norms 1 + 0.1 N and 0.1 N, the
    cls token N(0, 1)."""
    sh = shapes(k, c, dim, heads, taps)
    sizes = [math.prod(s) for s in sh.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(sh.items(), sizes):
        x = flat[at:at + n].reshape(shape)
        at += n
        if name == "cls_token":
            out[name] = x.clone()
        elif name.endswith("norm.weight"):
            out[name] = 1.0 + 0.1 * x
        elif len(shape) == 1:
            out[name] = 0.1 * x
        else:
            out[name] = x / math.sqrt(math.prod(shape[1:]))
    return out


def pinv(x: torch.Tensor, iters: int) -> torch.Tensor:
    a = torch.abs(x)
    col = a.sum(dim=-1)
    row = a.sum(dim=-2)
    z = x.transpose(-1, -2) / (torch.max(col) * torch.max(row))
    eye = torch.eye(x.shape[-1], device=x.device)[None]
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


def drop(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * (keep.to(x.dtype) * (1.0 / (1.0 - p)))


def nystrom(pp: Dict[str, torch.Tensor], x: torch.Tensor, heads: int,
            landmarks: int, iters: int, p_drop: float, generator
            ) -> torch.Tensor:
    n, d = x.shape
    if n % landmarks:
        x = F.pad(x, (0, 0, landmarks - n % landmarks, 0), value=0.0)
    big = x.shape[0]
    q, k, v = (x @ pp["to_qkv.weight"].T).chunk(3, dim=-1)
    q, k, v = (t.reshape(big, heads, d // heads).transpose(0, 1)
               for t in (q, k, v))
    q = q * (d // heads) ** -0.5
    per = math.ceil(n / landmarks)
    ql = q.reshape(heads, landmarks, per, -1).sum(dim=2) / per
    kl = k.reshape(heads, landmarks, per, -1).sum(dim=2) / per
    a1 = torch.softmax(q @ kl.transpose(-1, -2), dim=-1)
    a2 = torch.softmax(ql @ kl.transpose(-1, -2), dim=-1)
    a3 = torch.softmax(ql @ k.transpose(-1, -2), dim=-1)
    out = (a1 @ pinv(a2, iters)) @ (a3 @ v)
    taps = pp["res_conv.weight"].shape[2]
    out = out + F.conv2d(v[None], pp["res_conv.weight"],
                         padding=(taps // 2, 0), groups=heads)[0]
    out = out.transpose(0, 1).reshape(big, d)
    out = out @ pp["to_out.0.weight"].T + pp["to_out.0.bias"]
    out = out[-n:]
    return drop(out, p_drop, generator) if p_drop > 0 else out


def forward(p: Dict[str, torch.Tensor], f: torch.Tensor,
            generator: Optional[torch.Generator] = None, *,
            p_drop: float = 0.1, landmarks: int = 256, iters: int = 6,
            tf32: bool = False) -> torch.Tensor:
    """The bag logits ``[C]``; ``p_drop`` 0 is eval."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    d = p["cls_token"].shape[-1]
    heads = p["layer1.attn.res_conv.weight"].shape[0]
    h = torch.relu(f @ p["_fc1.0.weight"].T + p["_fc1.0.bias"])
    n = h.shape[0]
    side = int(math.ceil(math.sqrt(n)))
    h = torch.cat([h, h[:side * side - n]], dim=0)
    x = torch.cat([p["cls_token"][0], h], dim=0)
    for i, layer in enumerate(("layer1", "layer2")):
        if i == 1:
            g = x[1:].transpose(0, 1).reshape(1, d, side, side)
            conv = {name: F.conv2d(g, p[f"pos_layer.{name}.weight"],
                                   p[f"pos_layer.{name}.bias"],
                                   padding=size // 2, groups=d)
                    for name, size in PPEG}
            g = conv["proj"] + g + conv["proj1"] + conv["proj2"]
            x = torch.cat([x[:1], g.reshape(d, -1).transpose(0, 1)], dim=0)
        pp = {k[len(layer) + 6:]: v for k, v in p.items()
              if k.startswith(layer + ".attn.")}
        y = F.layer_norm(x, (d,), p[f"{layer}.norm.weight"],
                         p[f"{layer}.norm.bias"])
        x = x + nystrom(pp, y, heads, landmarks, iters, p_drop, generator)
    x = F.layer_norm(x, (d,), p["norm.weight"], p["norm.bias"])[0]
    return x @ p["_fc2.weight"].T + p["_fc2.bias"]


def loss(p: Dict[str, torch.Tensor], f: torch.Tensor, y: torch.Tensor,
         generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
    """Cross-entropy of the bag logits against the bag's class (the
    largest entry of its one-hot label ``y``)."""
    logits = forward(p, f, generator, **kw)
    return F.cross_entropy(logits[None], y.argmax()[None])


class LookaheadRAdam:
    """Lookahead (k, alpha; slow weights from the initial ones) around
    RAdam with decoupled weight decay, as torch.optim.RAdam states it."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, k: int = 6, alpha: float = 0.5):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.k, self.alpha = k, alpha
        self.m = {n: torch.zeros_like(v) for n, v in params.items()}
        self.v = {n: torch.zeros_like(v) for n, v in params.items()}
        self.slow = {n: v.detach().clone() for n, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        t, lr = self.t, self.lr
        b1, b2 = self.betas
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho = rho_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        for n, p in params.items():
            g = grads[n]
            p.mul_(1.0 - lr * self.wd)
            self.m[n] = b1 * self.m[n] + (1.0 - b1) * g
            self.v[n] = b2 * self.v[n] + (1.0 - b2) * g * g
            m_hat = self.m[n] / (1.0 - b1 ** t)
            if rho > 5.0:
                rect = math.sqrt((rho - 4) * (rho - 2) * rho_inf
                                 / ((rho_inf - 4) * (rho_inf - 2) * rho))
                p.sub_(lr * m_hat * math.sqrt(1.0 - b2 ** t)
                       / (self.v[n].sqrt() + self.eps) * rect)
            else:
                p.sub_(lr * m_hat)
        if t % self.k == 0:
            for n, p in params.items():
                self.slow[n] += self.alpha * (p - self.slow[n])
                p.copy_(self.slow[n])
