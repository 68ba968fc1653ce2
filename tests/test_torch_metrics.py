"""The port's numpy metrics against pevit_tpu/evaluation/metrics.py (built
on scikit-learn), on seeded scores with ties, to 1e-12."""

import warnings

import numpy as np
import pytest

from pevit_tpu.evaluation import metrics as jm
from pevit_tpu_torch.evaluation import metrics as tm


def _same(a, b):
    assert (np.isnan(a) and np.isnan(b)) or abs(a - b) < 1e-12, (a, b)


def _case(seed, n=37, c=5, decimals=1):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.random((n, c)), decimals)  # rounding makes ties
    return rng, scores, rng.integers(0, c, n)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", ["accuracy", "balanced_accuracy_score", "map_11_points"])
def test_multiclass_metrics_match(seed, name):
    _, scores, labels = _case(seed)
    _same(getattr(tm, name)(labels, scores), getattr(jm, name)(labels, scores))


@pytest.mark.parametrize("seed", range(4))
def test_map_11_points_multilabel_matches(seed):
    rng, scores, _ = _case(seed, decimals=2)
    labels = (rng.random(scores.shape) < 0.3).astype(np.int64)
    labels[:, 0] = 0  # a class without positives is left out on both sides
    _same(tm.map_11_points(labels, scores), jm.map_11_points(labels, scores))


def test_map_11_points_nan_prone_cases():
    """No positive anywhere -> 0.0; NaN scores are refused on both sides
    (the trainer scores such an epoch 0)."""
    scores = np.random.default_rng(0).random((6, 3))
    _same(tm.map_11_points(np.zeros((6, 3)), scores), jm.map_11_points(np.zeros((6, 3)), scores))
    scores[2, 1] = np.nan
    labels = np.eye(3)[[0, 1, 2, 0, 1, 2]]
    for fn in (tm.map_11_points, jm.map_11_points):
        with pytest.raises(ValueError):
            fn(labels, scores)


@pytest.mark.parametrize("seed", range(4))
def test_roc_auc_binary_matches(seed):
    rng, scores, _ = _case(seed, c=2)
    labels = rng.integers(0, 2, scores.shape[0])
    _same(tm.roc_auc(labels, scores), jm.roc_auc(labels, scores))


def test_roc_auc_multilabel_and_one_class_match():
    rng, scores, _ = _case(7, c=4, decimals=2)
    labels = (rng.random(scores.shape) < 0.4).astype(np.int64)
    _same(tm.roc_auc(labels, scores), jm.roc_auc(labels, scores))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(tm.roc_auc(np.ones(scores.shape[0]), scores[:, :2]),
              jm.roc_auc(np.ones(scores.shape[0]), scores[:, :2]))


@pytest.mark.parametrize("name", ["accuracy", "mean-per-class", "11point_mAP", "roc_auc", "nope"])
def test_get_metric_names(name):
    got, want = tm.get_metric(name), jm.get_metric(name)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.__name__ == want.__name__
