"""``.pth`` state_dict I/O (counterpart of tpumil/io/torch_ckpt.py).

Aggregator schema (the reference's train_tcga.py ``torch.save``):

    i_classifier.fc.0.{weight,bias}   [C, K], [C]
    b_classifier.q.0.{weight,bias}    [128, K]    (nonlinear q, layer 0)
    b_classifier.q.2.{weight,bias}    [128, 128]  (nonlinear q, layer 2)
    b_classifier.q.{weight,bias}      [128, K]    (linear q variant)
    b_classifier.v.1.{weight,bias}    [K, K]      (passing_v variant)
    b_classifier.fcc.{weight,bias}    [C, C, K], [C]

Some loaders see ``i_classifier.fc.{weight,bias}``; both spellings load.
The port's ``DSMIL`` module has exactly these ``state_dict`` keys, in this
order, so a checkpoint loads with ``strict=True`` and the module's
``state_dict`` is what :func:`save_mil_pth` writes.

The other registry models have the JAX package's schemas:

    ABMIL:     i_classifier.fc.{weight,bias}, b_classifier.attention_{v,u,w}.*,
               b_classifier.fc.*
    pooling:   i_classifier.fc.{weight,bias}, pooling.mode (0-d: 0.0 mean,
               1.0 max)

TransMIL has its reference module's keys (github.com/szc19990412/TransMIL
``models/TransMIL.py``), D = 512, H = 8 heads, K features, C classes:

    cls_token                            [1, 1, D]
    pos_layer.proj{,1,2}.{weight,bias}   [D, 1, k, k], [D]  (k = 7, 5, 3)
    _fc1.0.{weight,bias}                 [D, K], [D]
    layer{1,2}.norm.{weight,bias}        [D]
    layer{1,2}.attn.to_qkv.weight        [3D, D]
    layer{1,2}.attn.to_out.0.{weight,bias}  [D, D], [D]
    layer{1,2}.attn.res_conv.weight      [H, 1, 33, 1]
    norm.{weight,bias}                   [D]
    _fc2.{weight,bias}                   [C, D], [C]

The landmarks, the pseudo-inverse's iterations and the dropout are not in
the weights: a loaded TransMIL takes ``models/transmil.ARCH``'s.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Mapping, Tuple, Union

import torch

from tpumil_torch.models.dsmil import DSMILConfig
from tpumil_torch.models.registry import get_model


def load_state_dict(path: str) -> "collections.OrderedDict":
    """A ``.pth`` state_dict as an OrderedDict of CPU tensors, in saved
    order (the positional surgery depends on it). Tensors only: the file
    is loaded with ``weights_only=True``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return collections.OrderedDict((k, v.detach()) for k, v in sd.items())


def save_state_dict(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``{name: tensor}`` as a ``.pth`` of f32 CPU tensors, in the
    given order (the embedder export's positional layout)."""
    torch.save(collections.OrderedDict(
        (k, v.detach().to("cpu", torch.float32).contiguous().clone())
        for k, v in sd.items()), path)


def strip_projection_head(sd: "collections.OrderedDict",
                          n: int = 4) -> "collections.OrderedDict":
    """Drop the last ``n`` entries (the SimCLR projection MLP), the
    reference's 4x ``popitem()``."""
    keys = list(sd.keys())[: len(sd) - n]
    return collections.OrderedDict((k, sd[k]) for k in keys)


def dsmil_config_from_state_dict(sd) -> DSMILConfig:
    """Infer feats_size / num_classes / nonlinear / passing_v from keys."""
    w = sd.get("i_classifier.fc.0.weight", sd.get("i_classifier.fc.weight"))
    if w is None:
        raise KeyError("no i_classifier.fc[.0].weight in checkpoint "
                       f"(keys: {list(sd)[:8]}...)")
    num_classes, feats_size = w.shape
    return DSMILConfig(feats_size=int(feats_size), num_classes=int(num_classes),
                       nonlinear="b_classifier.q.0.weight" in sd,
                       passing_v="b_classifier.v.1.weight" in sd)


def mil_schema(sd) -> str:
    """The registry model a state_dict's keys belong to, in the JAX
    package's detection order: ``pooling.mode`` (above 0.5: maxpool),
    then ``b_classifier.attention_v.weight`` (abmil), else dsmil; a
    ``cls_token`` is TransMIL's."""
    if "cls_token" in sd:
        return "transmil"
    if "pooling.mode" in sd:
        return "maxpool" if float(sd["pooling.mode"]) > 0.5 else "meanpool"
    if "b_classifier.attention_v.weight" in sd:
        return "abmil"
    return "dsmil"


def load_mil_pth(path: str, device: torch.device
                 ) -> Tuple[torch.nn.Module, DSMILConfig, str]:
    """Load an aggregator checkpoint of any registry schema; returns
    ``(model in eval mode, cfg, model name)``. Loading is strict. Only the
    DSMIL schema has two spellings of the instance head, so only its
    ``i_classifier.fc.*`` keys are renamed to ``fc.0.*``."""
    sd = load_state_dict(path)
    name = mil_schema(sd)
    if name == "dsmil":
        sd = collections.OrderedDict(
            (k.replace("i_classifier.fc.", "i_classifier.fc.0.")
             if k in ("i_classifier.fc.weight", "i_classifier.fc.bias") else k,
             v) for k, v in sd.items())
        cfg = dsmil_config_from_state_dict(sd)
    elif name == "transmil":
        return _load_transmil(sd, device)
    else:
        num_classes, feats_size = sd["i_classifier.fc.weight"].shape
        cfg = DSMILConfig(feats_size=int(feats_size),
                          num_classes=int(num_classes))
    model = get_model(name)(cfg, device)
    model.load_state_dict(sd, strict=True)
    return model.eval(), cfg, name


def _load_transmil(sd, device: torch.device
                   ) -> Tuple[torch.nn.Module, DSMILConfig, str]:
    from tpumil_torch.models import transmil

    dim, feats_size = sd["_fc1.0.weight"].shape
    heads, _, taps, _ = sd["layer1.attn.res_conv.weight"].shape
    cfg = DSMILConfig(feats_size=int(feats_size),
                      num_classes=int(sd["_fc2.weight"].shape[0]))
    arch = dataclasses.replace(transmil.ARCH, dim=int(dim), heads=int(heads),
                               conv_taps=int(taps))
    model = transmil.TransMIL(cfg, device, arch)
    model.load_state_dict(sd, strict=True)
    return model.eval(), cfg, "transmil"


def save_mil_pth(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                 path: str, model: str = "dsmil") -> None:
    """Write an aggregator checkpoint: f32 CPU tensors under the module's
    ``state_dict`` keys, loadable by :func:`load_mil_pth` and by the JAX
    package's loader (and, for DSMIL, by the reference). ``model`` must
    name the schema the weights have."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    schema = mil_schema(sd)
    if schema != model:
        raise ValueError(f"weights of the {schema!r} schema cannot be saved "
                         f"as model {model!r}")
    save_state_dict(sd, path)
