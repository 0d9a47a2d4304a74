"""Shared aggregation helper of the inference paths (copy of the
framework-free part of tpumil/infer/common.py)."""

from __future__ import annotations

import numpy as np


def testing_flow_average(scores: np.ndarray,
                         ins_logits: np.ndarray) -> np.ndarray:
    """The reference testing-flow score: mean of the bag sigmoid and the
    max-instance sigmoid (attention_map.py:88, testing_tcga.py:150)."""
    max_logits = np.max(ins_logits, axis=0)
    return (scores + 1.0 / (1.0 + np.exp(-max_logits))) / 2.0
