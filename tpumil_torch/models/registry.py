"""Aggregator model registry (counterpart of tpumil/models/registry.py):
the reference's ``--model dsmil|abmil`` switch (train_tcga.py:224-227) plus
the paper's max- and mean-pooling baselines, and TransMIL (Shao et al.,
NeurIPS 2021), which the JAX package does not have.

``get_model(name)`` returns the model class. Each is built as
``cls(cfg, device)``, has the forward contract ``model(feats, mask,
ins_logits=..., dropout_generator=...) -> (ins_logits, bag_logits, A, B)``,
the static ``init_params(generator, cfg, device)``, and two class
attributes that the trainer reads:

  * ``objective``: ``"dual_stream"`` (DSMIL, ABMIL, pooling: BCE on the
    bag logits and on the max instance logit, ``max_instance_logits(
    ins_logits, mask)``, sigmoid scores) or ``"cross_entropy"``
    (TransMIL: softmax cross-entropy on the bag logits, softmax scores,
    and no instance stream: its forward returns None in the other three
    places);
  * ``recipe``: the optimizer, ``"adam"`` or ``"lookahead_radam"``
    (train/optim.py).

The paths built on the instance stream or on the attention refuse a
model without one by name (:func:`require_instance_stream`)."""

from __future__ import annotations

from tpumil_torch.models.abmil import ABMIL
from tpumil_torch.models.dsmil import DSMIL
from tpumil_torch.models.poolmil import MaxPool, MeanPool
from tpumil_torch.models.transmil import TransMIL

_MODELS = {"dsmil": DSMIL, "abmil": ABMIL, "meanpool": MeanPool,
           "maxpool": MaxPool, "transmil": TransMIL}


def get_model(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown MIL model {name!r}; choose from "
                         f"{sorted(_MODELS)}") from None


def require_instance_stream(name: str, where: str) -> None:
    """Raise when registry model ``name`` (unknown names raise too) has no
    instance stream, attention or bag embedding for ``where`` to use."""
    if get_model(name).objective != "dual_stream":
        raise ValueError(f"{where} cannot run model {name!r}: it has no "
                         f"instance stream, attention or bag embedding; "
                         f"train it with BagTrainer (train_wsi, train_mil)")
