"""Host-side evaluation metrics (counterpart of tpumil/train/metrics.py),
written in numpy and scipy: the JAX package calls scikit-learn, which the
port does not depend on.

``roc_curve`` reproduces scikit-learn's (descending-score thresholds with
ties merged, ``drop_intermediate=True``, a leading ``inf`` threshold, NaN
rates for a class with no samples) and ``roc_auc_score`` its trapezoidal
area, ties included, so thresholds and AUCs are the same numbers.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.integrate import trapezoid


def roc_curve(labels, scores, pos_label=1
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(fpr, tpr, thresholds)`` of ``sklearn.metrics.roc_curve`` with its
    defaults (no sample weights, ``drop_intermediate=True``)."""
    y = (np.asarray(labels).ravel() == pos_label).astype(np.float64)
    s = np.asarray(scores).ravel()
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    # the last index of every run of equal scores, then the end
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1.0 + idx.astype(np.float64) - tps
    thresholds = s[idx].astype(np.float64)
    if fps.shape[0] > 2:  # drop collinear points (no corner there)
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                    np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc_score(labels, scores) -> float:
    """Binary ROC AUC (trapezoids under :func:`roc_curve`; the larger of
    the two label values is the positive class)."""
    labels = np.asarray(labels).ravel()
    classes = np.unique(labels)
    if classes.size != 2:
        raise ValueError("ROC AUC needs both classes in labels")
    fpr, tpr, _ = roc_curve(labels == classes[1], scores, pos_label=True)
    return float(trapezoid(tpr, fpr))


def optimal_thresh(fpr, tpr, thresholds, p: float = 0.0):
    """Threshold minimising ``(fpr - tpr) - p * tpr / (fpr + tpr + 1)``
    (p=0 reduces to a Youden-like criterion)."""
    loss = (fpr - tpr) - p * tpr / (fpr + tpr + 1)
    idx = np.argmin(loss, axis=0)
    return fpr[idx], tpr[idx], thresholds[idx]


def multi_label_roc(labels: np.ndarray, predictions: np.ndarray,
                    num_classes: int,
                    ) -> Tuple[List[float], List[np.ndarray], List[float]]:
    """Per-class AUC + optimal thresholds. A split whose labels hold a
    single class gets AUC := 1, the reference's fallback."""
    if predictions.ndim == 1:
        predictions = predictions[:, None]
    if labels.ndim == 1:
        labels = labels[:, None]
    aucs, thresholds, thresholds_optimal = [], [], []
    for c in range(num_classes):
        label = labels[:, c]
        prediction = predictions[:, c]
        with np.errstate(invalid="ignore"):
            fpr, tpr, threshold = roc_curve(label, prediction, pos_label=1)
        _, _, threshold_optimal = optimal_thresh(fpr, tpr, threshold)
        if len(np.unique(label)) < 2:
            c_auc = 1.0
        else:
            c_auc = roc_auc_score(label, prediction)
        aucs.append(float(c_auc))
        thresholds.append(threshold)
        thresholds_optimal.append(float(threshold_optimal))
    return aucs, thresholds, thresholds_optimal


def binarize(predictions: np.ndarray, thresholds: Sequence[float]) -> np.ndarray:
    """Per-class threshold binarisation."""
    preds = np.array(predictions, dtype=np.float64, copy=True)
    if preds.ndim == 1:
        return (preds >= thresholds[0]).astype(np.float64)
    out = np.zeros_like(preds)
    for c in range(preds.shape[1]):
        out[:, c] = preds[:, c] >= thresholds[c]
    return out


def exact_match_score(labels: np.ndarray, binary_predictions: np.ndarray) -> float:
    """Fraction of bags whose full label vector is matched exactly. 1-D
    inputs are one bag per entry (binary task)."""
    labels = np.asarray(labels)
    binary_predictions = np.asarray(binary_predictions)
    if labels.ndim == 1:
        labels = labels[:, None]
    if binary_predictions.ndim == 1:
        binary_predictions = binary_predictions[:, None]
    return float(np.mean(np.all(labels == binary_predictions, axis=-1)))


def five_scores(bag_labels, bag_predictions
                ) -> Tuple[float, float, float, float, float]:
    """accuracy/AUC/precision/recall/F1 at the optimal threshold
    (precision, recall and F1 of the positive class; 0 where undefined)."""
    bag_labels = np.asarray(bag_labels, dtype=np.float64)
    bag_predictions = np.asarray(bag_predictions, dtype=np.float64)
    fpr, tpr, threshold = roc_curve(bag_labels, bag_predictions, pos_label=1)
    _, _, threshold_optimal = optimal_thresh(fpr, tpr, threshold)
    auc_value = roc_auc_score(bag_labels, bag_predictions)
    truth = bag_labels.astype(int)
    binary = (bag_predictions >= threshold_optimal).astype(int)
    tp = float(np.sum((binary == 1) & (truth == 1)))
    fp = float(np.sum((binary == 1) & (truth != 1)))
    fn = float(np.sum((binary != 1) & (truth == 1)))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    fscore = 2 * tp / (2 * tp + fn + fp) if 2 * tp + fn + fp > 0 else 0.0
    accuracy = 1.0 - np.count_nonzero(truth - binary) / len(bag_labels)
    return float(accuracy), float(auc_value), precision, recall, fscore


def current_score(avg_score: float, aucs: Sequence[float]) -> float:
    """Model-selection criterion ``(sum(aucs) + accuracy) / 2``."""
    return (sum(aucs) + avg_score) / 2.0


def _balanced_accuracy(labels: np.ndarray, preds: np.ndarray) -> float:
    """Mean per-class recall over the classes present in ``labels``."""
    recalls = [np.mean(preds[labels == c] == c) for c in np.unique(labels)]
    return float(np.mean(recalls))


def standalone_test_metrics(labels: np.ndarray, combined_predictions: np.ndarray,
                            num_classes: int) -> dict:
    """Final metrics of the standalone-test scheme: Hamming loss and subset
    accuracy for multi-class labels, accuracy and balanced accuracy for a
    binary one."""
    labels = np.asarray(labels)
    combined_predictions = np.asarray(combined_predictions)
    if num_classes > 1:
        return {
            "hamming_loss": float(np.mean(labels != combined_predictions)),
            "subset_accuracy": exact_match_score(labels, combined_predictions),
        }
    labels = np.atleast_1d(np.squeeze(labels))
    combined_predictions = np.atleast_1d(np.squeeze(combined_predictions))
    return {
        "accuracy": float(np.mean(labels == combined_predictions)),
        "balanced_accuracy": _balanced_accuracy(labels, combined_predictions),
    }
