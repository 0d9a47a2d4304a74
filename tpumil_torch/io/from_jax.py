"""The JAX package's parameters -> the port's ``state_dict``s.

Inputs are the JAX pytrees with numpy (or numpy-convertible) leaves; this
module imports neither ``jax`` nor ``tpumil``. It lets the parity tests run
both packages on the same weights.
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
