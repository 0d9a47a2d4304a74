"""The JAX package's parameters <-> the port's ``state_dict``s.

The JAX side is pytrees with numpy (or numpy-convertible) leaves; this
module imports neither ``jax`` nor ``tpumil``. It lets the parity tests run
both packages on the same weights and compare trained parameters leaf by
leaf (:func:`mil_params`), for every registry model.
"""

from __future__ import annotations

import collections
from typing import Dict

import numpy as np
import torch

from tpumil_torch.models import resnet
from tpumil_torch.models.resnet import ResNetConfig


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def resnet_state_dict(params: Dict, cfg: ResNetConfig,
                      prefix: str = "") -> "collections.OrderedDict":
    """``{torchvision name: array}`` with HWIO convs -> OIHW tensors."""
    convs = {name for name, _, _ in resnet.conv_specs(cfg)}
    sd = collections.OrderedDict()
    for name in resnet.param_names(cfg):
        v = np.asarray(params[name], np.float32)
        sd[prefix + name] = _t(np.transpose(v, (3, 2, 0, 1)) if name in convs
                               else v)
    return sd


def embedder_state_dict(params: Dict, cfg: ResNetConfig
                        ) -> "collections.OrderedDict":
    """``{"backbone": {...}, "fc": {"w", "b"}}`` -> ``Embedder.state_dict``."""
    sd = resnet_state_dict(params["backbone"], cfg, prefix="feature_extractor.")
    sd["fc.weight"] = _t(params["fc"]["w"])
    sd["fc.bias"] = _t(params["fc"]["b"])
    return sd


def simclr_state_dict(params: Dict, cfg) -> "collections.OrderedDict":
    """``{"backbone": {...}, "l1": {"w", "b"}, "l2": {"w", "b"}}`` ->
    ``models/simclr.SimCLR.state_dict`` (``cfg`` a ``SimCLRConfig``)."""
    sd = resnet_state_dict(params["backbone"], cfg.resnet_cfg,
                           prefix="backbone.")
    for layer in ("l1", "l2"):
        sd[f"{layer}.weight"] = _t(params[layer]["w"])
        sd[f"{layer}.bias"] = _t(params[layer]["b"])
    return sd


def baseline_encoder_state_dict(params: Dict) -> "collections.OrderedDict":
    """``{"conv0".."conv3": {"w" HWIO, "b"}, "l1", "l2"}`` ->
    ``models/baseline_encoder.BaselineEncoder.state_dict``."""
    sd = collections.OrderedDict()
    for i in range(4):
        sd[f"conv{i}.weight"] = _t(np.transpose(
            np.asarray(params[f"conv{i}"]["w"], np.float32), (3, 2, 0, 1)))
        sd[f"conv{i}.bias"] = _t(params[f"conv{i}"]["b"])
    for layer in ("l1", "l2"):
        sd[f"{layer}.weight"] = _t(params[layer]["w"])
        sd[f"{layer}.bias"] = _t(params[layer]["b"])
    return sd


def dsmil_state_dict(params: Dict) -> "collections.OrderedDict":
    """``{i_fc, q: {w0, b0, w2, b2} | {w, b}, v, fcc}`` -> ``DSMIL.state_dict``
    (the reference schema)."""
    sd = collections.OrderedDict()
    sd["i_classifier.fc.0.weight"] = _t(params["i_fc"]["w"])
    sd["i_classifier.fc.0.bias"] = _t(params["i_fc"]["b"])
    q = params["q"]
    if "w0" in q:
        sd["b_classifier.q.0.weight"] = _t(q["w0"])
        sd["b_classifier.q.0.bias"] = _t(q["b0"])
        sd["b_classifier.q.2.weight"] = _t(q["w2"])
        sd["b_classifier.q.2.bias"] = _t(q["b2"])
    else:
        sd["b_classifier.q.weight"] = _t(q["w"])
        sd["b_classifier.q.bias"] = _t(q["b"])
    if params.get("v"):
        sd["b_classifier.v.1.weight"] = _t(params["v"]["w"])
        sd["b_classifier.v.1.bias"] = _t(params["v"]["b"])
    sd["b_classifier.fcc.weight"] = _t(params["fcc"]["w"])
    sd["b_classifier.fcc.bias"] = _t(params["fcc"]["b"])
    return sd


def dsmil_params(sd) -> Dict:
    """The reverse of :func:`dsmil_state_dict`: a ``DSMIL.state_dict`` ->
    the JAX package's parameter pytree with numpy leaves."""
    def a(key):
        return _a(sd[key])

    params = {"i_fc": {"w": a("i_classifier.fc.0.weight"),
                       "b": a("i_classifier.fc.0.bias")},
              "fcc": {"w": a("b_classifier.fcc.weight"),
                      "b": a("b_classifier.fcc.bias")},
              "v": {}}
    if "b_classifier.q.0.weight" in sd:
        params["q"] = {"w0": a("b_classifier.q.0.weight"),
                       "b0": a("b_classifier.q.0.bias"),
                       "w2": a("b_classifier.q.2.weight"),
                       "b2": a("b_classifier.q.2.bias")}
    else:
        params["q"] = {"w": a("b_classifier.q.weight"),
                       "b": a("b_classifier.q.bias")}
    if "b_classifier.v.1.weight" in sd:
        params["v"] = {"w": a("b_classifier.v.1.weight"),
                       "b": a("b_classifier.v.1.bias")}
    return params


# (JAX group, leaf) of each ABMIL state_dict key, in the schema's order
_ABMIL_KEYS = {
    "i_classifier.fc.weight": ("i_fc", "w"), "i_classifier.fc.bias": ("i_fc", "b"),
    "b_classifier.attention_v.weight": ("att_v", "w"),
    "b_classifier.attention_v.bias": ("att_v", "b"),
    "b_classifier.attention_u.weight": ("att_u", "w"),
    "b_classifier.attention_u.bias": ("att_u", "b"),
    "b_classifier.attention_w.weight": ("att_w", "w"),
    "b_classifier.attention_w.bias": ("att_w", "b"),
    "b_classifier.fc.weight": ("bag_fc", "w"), "b_classifier.fc.bias": ("bag_fc", "b"),
}


def _a(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float32)


def abmil_state_dict(params: Dict) -> "collections.OrderedDict":
    """``{i_fc, att_v, att_u, att_w, bag_fc}`` -> ``ABMIL.state_dict``."""
    return collections.OrderedDict(
        (key, _t(params[grp][leaf])) for key, (grp, leaf) in _ABMIL_KEYS.items())


def abmil_params(sd) -> Dict:
    """The reverse of :func:`abmil_state_dict`."""
    params: Dict = {}
    for key, (grp, leaf) in _ABMIL_KEYS.items():
        params.setdefault(grp, {})[leaf] = _a(sd[key])
    return params


def poolmil_state_dict(params: Dict, model: str) -> "collections.OrderedDict":
    """``{i_fc}`` -> the ``state_dict`` of ``MeanPool`` or ``MaxPool``
    (``model`` names which: its ``pooling.mode`` is 0.0 or 1.0)."""
    if model not in ("meanpool", "maxpool"):
        raise ValueError(f"not a pooling model: {model!r}")
    return collections.OrderedDict([
        ("i_classifier.fc.weight", _t(params["i_fc"]["w"])),
        ("i_classifier.fc.bias", _t(params["i_fc"]["b"])),
        ("pooling.mode", torch.tensor(0.0 if model == "meanpool" else 1.0))])


def poolmil_params(sd) -> Dict:
    """The reverse of :func:`poolmil_state_dict` (the mode is the model's,
    not a parameter)."""
    return {"i_fc": {"w": _a(sd["i_classifier.fc.weight"]),
                     "b": _a(sd["i_classifier.fc.bias"])}}


def mil_state_dict(params: Dict, model: str) -> "collections.OrderedDict":
    """The JAX parameters of registry model ``model`` -> its port module's
    ``state_dict``."""
    if model == "dsmil":
        return dsmil_state_dict(params)
    if model == "abmil":
        return abmil_state_dict(params)
    return poolmil_state_dict(params, model)


def mil_params(sd, model: str) -> Dict:
    """The reverse of :func:`mil_state_dict`."""
    return {"dsmil": dsmil_params, "abmil": abmil_params}.get(
        model, poolmil_params)(sd)
