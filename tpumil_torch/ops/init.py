"""Parameter initializers (counterpart of tpumil/ops/init.py).

``orthogonal_torch`` has the orientation of ``torch.nn.init.orthogonal_``:
the weight is viewed as ``(shape[0], prod(shape[1:]))``, QR-orthogonalised
with sign correction, and reshaped back. It draws exactly as
``orthogonal_`` does, from an explicit ``torch.Generator``, so an init is a
function of its seed and equals ``orthogonal_`` with the same generator.
"""

from __future__ import annotations

import math

import torch


def orthogonal_torch(generator: torch.Generator, shape,
                     gain: float = 1.0) -> torch.Tensor:
    rows = shape[0]
    cols = math.prod(shape[1:]) if len(shape) > 1 else 1
    a = torch.randn((rows, cols), generator=generator, dtype=torch.float32)
    if rows < cols:  # QR of the tall matrix gives orthonormal columns
        a = a.T
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return (gain * q).reshape(shape).contiguous()
