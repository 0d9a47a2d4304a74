"""Aggregator model registry (counterpart of tpumil/models/registry.py):
the reference's ``--model dsmil|abmil`` switch (train_tcga.py:224-227) plus
the paper's max- and mean-pooling baselines.

``get_model(name)`` returns the model class. Each is built as
``cls(cfg, device)``, has the forward contract ``model(feats, mask,
ins_logits=..., dropout_generator=...) -> (ins_logits, bag_logits, A, B)``,
and the static ``init_params(generator, cfg, device)`` and
``max_instance_logits(ins_logits, mask)``."""

from __future__ import annotations

from tpumil_torch.models.abmil import ABMIL
from tpumil_torch.models.dsmil import DSMIL
from tpumil_torch.models.poolmil import MaxPool, MeanPool

_MODELS = {"dsmil": DSMIL, "abmil": ABMIL, "meanpool": MeanPool,
           "maxpool": MaxPool}


def get_model(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown MIL model {name!r}; choose from "
                         f"{sorted(_MODELS)}") from None
