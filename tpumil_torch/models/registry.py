"""Aggregator model registry (counterpart of tpumil/models/registry.py).

``get_model(name)`` returns the model class, built as ``cls(cfg, device)``.
Only DSMIL is ported so far; the other names are known and raise."""

from __future__ import annotations

from tpumil_torch.models.dsmil import DSMIL

_MODELS = {"dsmil": DSMIL}
_LATER = ("abmil", "meanpool", "maxpool")


def get_model(name: str):
    if name in _MODELS:
        return _MODELS[name]
    if name in _LATER:
        raise NotImplementedError(
            f"MIL model {name!r} is not ported to tpumil_torch yet; it comes "
            "with a later slice (ROADMAP.md, Queue 1)")
    raise ValueError(f"unknown MIL model {name!r}; choose from "
                     f"{sorted(_MODELS) + list(_LATER)}")
