"""Bags of instance features for the training cells, from a cell's
traffic parameters:

    {"bags": 256, "median": 4096, "sigma": 1.0, "min": 256, "max": 65536,
     "feats": 512, "classes": 2}

Bag sizes are log-normal, taken as the ``bags`` quantiles at
``(i + 0.5) / bags`` of LogNormal(log(median), sigma) clipped to
``[min, max]``: every seed gets the same set of sizes, so the work is the
same from seed to seed, and the seed draws their order, the labels (one
class a bag, as a TCGA lung slide is LUAD or LUSC) and the features.
Features are non-negative, as pooled post-ReLU embeddings are, and are made
on the device in one call.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Tuple

import numpy as np


def bag_sizes(params: dict) -> np.ndarray:
    """The cell's bag sizes in ascending order (the same for every seed)."""
    n = int(params["bags"])
    mu, sigma = math.log(float(params["median"])), float(params["sigma"])
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    sizes = np.rint(np.exp(mu + sigma * z))
    return np.clip(sizes, int(params["min"]), int(params["max"])).astype(
        np.int64)


def draw(params: dict, rng: np.random.Generator
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(sizes in this seed's order [bags], one-hot labels [bags, classes])."""
    sizes = rng.permutation(bag_sizes(params))
    c = int(params["classes"])
    labels = np.zeros((len(sizes), c), np.float32)
    labels[np.arange(len(sizes)), rng.integers(0, c, len(sizes))] = 1.0
    return sizes, labels


def features(total: int, k: int, generator, device):
    """``[total, k]`` f32 features, |N(0, 1)|, made on ``device``."""
    import torch

    x = torch.randn((total, k), generator=generator, device=device)
    return x.abs_()
