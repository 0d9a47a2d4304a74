"""The JAX package's parameters <-> the port's ``state_dict``s.

The JAX side is pytrees with numpy (or numpy-convertible) leaves; this
module imports neither ``jax`` nor ``tpumil``. It lets the parity tests run
both packages on the same weights and compare trained parameters leaf by
leaf (:func:`dsmil_params`).
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
        return sd[key].detach().cpu().numpy().astype(np.float32)

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
