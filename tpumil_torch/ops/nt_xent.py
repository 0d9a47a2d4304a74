"""NT-Xent (normalized-temperature cross-entropy) contrastive loss
(counterpart of tpumil/ops/nt_xent.py).

The reference's semantics (simclr/loss/nt_xent.py:47-65): the rows
``cat([zjs, zis])`` give a (2N)x(2N) similarity matrix; each anchor's
positive is its other view (offset +-N), its denominator every other row
but itself; the loss is the mean over the 2N anchors of

  loss_i = -sim(i, pair(i))/t + logsumexp_{j != i} sim(i, j)/t
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row normalization with a finite gradient at x = 0: the rsqrt form
    (``x / max(|x|, e)`` gives 0/0 in the norm's own gradient there)."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def nt_xent_loss(zis: torch.Tensor, zjs: torch.Tensor,
                 temperature: float = 0.5,
                 use_cosine_similarity: bool = True) -> torch.Tensor:
    """zis/zjs: [N, D] projections of the two views; a 0-d tensor."""
    z = torch.cat([zjs, zis], dim=0)
    if use_cosine_similarity:
        z = l2_normalize(z)
    sim = (z @ z.T) / temperature                    # [2N, 2N]
    n = zis.shape[0]
    two_n = 2 * n
    idx = torch.arange(two_n, device=z.device)
    pos = sim[idx, (idx + n) % two_n]                # positive logits
    self_mask = torch.eye(two_n, dtype=torch.bool, device=z.device)
    lse = torch.logsumexp(sim.masked_fill(self_mask, float("-inf")), dim=-1)
    return (lse - pos).mean()
