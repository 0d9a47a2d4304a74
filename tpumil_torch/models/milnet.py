"""Object-style facade over the registry aggregators (counterpart of
tpumil/models/milnet.py).

Users of the reference compose ``MILNet(IClassifier, BClassifier)``
(dsmil.py:64-74); this facade offers the same mental model:

    net = MILNet.create(feats_size=512, num_classes=1)        # fresh
    net = MILNet.from_pth("aggregator.pth")                   # reference ckpt
    ins_logits, bag_logits, A, B = net(feats, mask)
    scores = net.score(feats, mask)                           # sigmoid bag
    net.save_pth("out.pth")                                   # reference ckpt

``device`` None is the card (raises without one). The forward runs in
``cfg.compute_dtype``: a bf16 facade is ``MILNet(module, cfg_bf16)``, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpumil_torch.models.dsmil import DSMILConfig, sigmoid
from tpumil_torch.models.registry import get_model
from tpumil_torch.utils.device import select_device


def _device(device: Optional[torch.device]) -> torch.device:
    return select_device("cuda") if device is None else device


@dataclasses.dataclass
class MILNet:
    module: torch.nn.Module
    cfg: DSMILConfig
    model: str = "dsmil"

    @classmethod
    def create(cls, feats_size: int, num_classes: int, *,
               nonlinear: bool = True, passing_v: bool = False,
               model: str = "dsmil", seed: int = 0,
               device: Optional[torch.device] = None) -> "MILNet":
        cfg = DSMILConfig(feats_size=feats_size, num_classes=num_classes,
                          nonlinear=nonlinear, passing_v=passing_v)
        module = get_model(model).init_params(
            torch.Generator().manual_seed(seed), cfg, _device(device))
        return cls(module, cfg, model)

    @classmethod
    def from_pth(cls, path: str,
                 device: Optional[torch.device] = None) -> "MILNet":
        """A reference-schema (DSMIL) aggregator ``.pth``."""
        from tpumil_torch.io import torch_ckpt

        module, cfg, name = torch_ckpt.load_mil_pth(path, _device(device))
        if name != "dsmil":
            raise ValueError(f"{path} holds a {name!r} aggregator; the "
                             "reference .pth schema covers dsmil only")
        return cls(module, cfg, "dsmil")

    def save_pth(self, path: str) -> None:
        from tpumil_torch.io import torch_ckpt

        if self.model != "dsmil":
            raise ValueError("reference .pth schema covers the dsmil model only")
        torch_ckpt.save_mil_pth(self.module, path)

    def _tensor(self, x) -> torch.Tensor:
        device = next(self.module.parameters()).device
        return torch.as_tensor(x, device=device)

    def __call__(self, feats, mask=None):
        """``(ins_logits, bag_logits, A, B)`` of feats ``[N, K]`` or
        ``[B, N, K]`` (numpy or tensors) with an optional bool mask, in
        ``cfg.compute_dtype``."""
        with torch.no_grad():
            return self.module(self._tensor(feats).float(),
                               None if mask is None else self._tensor(mask).bool(),
                               compute_dtype=self.cfg.compute_dtype)

    def score(self, feats, mask=None, *, average: bool = False) -> np.ndarray:
        """Sigmoid bag scores. ``average`` adds the sigmoid of the max
        instance logit WITHOUT dividing, as the trainer's --average does
        (train_tcga.py:107), so saved optimal thresholds transfer
        (testing_tcga.py:87 divides by 2; divide yourself for that scale).
        The scores are computed in ``cfg.compute_dtype`` and returned as
        float32 (numpy has no bf16); bf16 values are exact in float32."""
        c, bag_logits, _, _ = self(feats, mask)
        s = sigmoid(bag_logits)
        if average:
            s = s + sigmoid(self.module.max_instance_logits(
                c, None if mask is None else self._tensor(mask).bool()))
        return s.float().cpu().numpy()
