"""Per-dataset evaluation metrics, in numpy only.

Counterpart of ``pevit_tpu/evaluation/metrics.py``, which builds two of the
four on scikit-learn; the port computes them with numpy, to the same
semantics (the tests hold each one against the JAX package's):

* ``accuracy``       — top-1;
* ``mean-per-class`` — balanced accuracy: the mean recall over the classes
  present in ``y_label`` (sklearn's ``balanced_accuracy_score``);
* ``11point_mAP``    — VOC 11-point interpolated mAP over sklearn's
  ``precision_recall_curve`` points: one operating point per distinct score,
  plus the terminal (recall 0, precision 1) point;
* ``roc_auc``        — binary ROC-AUC (the positive column of a two-column
  score), or the macro mean over the columns of a multilabel indicator;
  NaN where ``y_label`` holds one class only.

All take ``(y_label, y_pred)`` where ``y_pred`` are probability scores of
shape (N, C).  Scores that are not finite raise ``ValueError``, as sklearn's
input checks do; the trainer scores such an epoch 0.
"""

from __future__ import annotations

import logging

import numpy as np

MULTILABEL_DATASETS = {"voc-2007-classification", "chestx-ray8"}


def _finite(scores: np.ndarray) -> np.ndarray:
    scores = np.asarray(scores)
    if not np.isfinite(scores).all():
        raise ValueError("scores contain NaN or infinity")
    return scores


def accuracy(y_label: np.ndarray, y_pred: np.ndarray) -> float:
    """Top-1 accuracy over probability scores."""
    pred = np.asarray(y_pred).argmax(axis=1)
    return float((pred == np.asarray(y_label).reshape(-1)).mean())


def balanced_accuracy_score(y_label: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean-per-class recall over the classes present in ``y_label``."""
    pred = np.asarray(y_pred).argmax(axis=1)
    y = np.asarray(y_label).reshape(-1)
    return float(np.mean([(pred[y == c] == c).mean() for c in np.unique(y)]))


def _pr_points(gt: np.ndarray, scores: np.ndarray) -> tuple:
    """(precision, recall) at every distinct score threshold, plus the
    terminal (precision 1, recall 0) point."""
    order = np.argsort(-scores, kind="mergesort")
    s, y = scores[order], gt[order].astype(np.float64)
    last = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]  # end of each tie group
    tps = np.cumsum(y)[last]
    fps = last + 1 - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return np.r_[precision, 1.0], np.r_[recall, 0.0]


def map_11_points(y_label: np.ndarray, y_pred_proba: np.ndarray) -> float:
    """VOC 11-point interpolated mean average precision.

    y_label: (N, C) binary multilabel matrix or (N,) class ids; y_pred_proba:
    (N, C) scores.  AP per class = mean over recall thresholds {0, 0.1, ...,
    1.0} of the interpolated precision max_{r' >= r} p(r'); classes without
    a positive are left out; mAP = mean over the rest (0 if none)."""
    y_label = np.asarray(y_label)
    scores = _finite(y_pred_proba)
    if y_label.ndim == 1:
        onehot = np.zeros_like(scores)
        onehot[np.arange(len(y_label)), y_label.astype(int)] = 1
        y_label = onehot
    aps = []
    for c in range(scores.shape[1]):
        gt = y_label[:, c] > 0
        if not gt.any():
            continue
        precision, recall = _pr_points(gt, scores[:, c])
        ap = 0.0
        for r in np.linspace(0.0, 1.0, 11):
            mask = recall >= r
            ap += float(precision[mask].max()) if mask.any() else 0.0
        aps.append(ap / 11.0)
    return float(np.mean(aps)) if aps else 0.0


def _binary_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve = the Mann-Whitney statistic with ties
    counted one half (average ranks)."""
    classes = np.unique(y)
    if classes.size == 1:
        return float("nan")  # undefined, as sklearn answers (with a warning)
    if classes.size != 2:
        raise ValueError(f"binary ROC-AUC takes two classes, got {classes.size}")
    pos = y == classes[1]
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    ranks = np.empty(s.size, np.float64)
    starts = np.r_[0, np.nonzero(np.diff(s))[0] + 1]
    ends = np.r_[starts[1:], s.size]
    for a, b in zip(starts, ends):
        ranks[a:b] = 0.5 * (a + b + 1)  # mean of the 1-based ranks a+1 .. b
    rank = np.empty_like(ranks)
    rank[order] = ranks
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((rank[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC; binary datasets score the positive column."""
    y_true = np.asarray(y_true)
    y_score = _finite(y_score)
    if y_score.ndim == 2 and y_score.shape[1] == 2:
        return _binary_auc(y_true.reshape(-1), y_score[:, 1])
    if y_score.ndim == 1:
        return _binary_auc(y_true.reshape(-1), y_score)
    if y_true.shape != y_score.shape:
        raise ValueError("multiclass ROC-AUC needs a multilabel indicator y_true")
    return float(np.mean([_binary_auc(y_true[:, c], y_score[:, c])
                          for c in range(y_score.shape[1])]))


def get_metric(metric_name: str):
    if metric_name == "accuracy":
        return accuracy
    if metric_name == "mean-per-class":
        return balanced_accuracy_score
    if metric_name == "11point_mAP":
        return map_11_points
    if metric_name == "roc_auc":
        return roc_auc
    logging.error("Undefined metric: %s", metric_name)
    return None
