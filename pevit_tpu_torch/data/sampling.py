"""Deterministic few-shot sampling and class-balanced validation splitting.

A copy of ``pevit_tpu/data/sampling.py`` (the port imports nothing of the
JAX package); the splits it gives are bit-identical to the reference's.

Reproduces the reference data-selection semantics exactly (they decide WHICH
images a run trains on, so accuracy parity depends on them):

* class-balanced 0.2 validation split (feature.py:137-172): per class, the
  FIRST ceil(0.2 * n_c) indices in dataset order go to val; train is the
  ascending complement.  The multilabel variant is the reference's greedy
  cover loop.
* few-shot subsets: the reference delegates to the external
  ``vision_datasets`` package's ``sample_few_shot_subset(n, seed)``
  (feature.py:591-594).  That implementation greedily scans the dataset in a
  seeded random order, keeping images while any of their classes still needs
  samples (multiclass: exactly n per class where available).  Reimplemented
  here from that contract.
"""

from __future__ import annotations

import math

import numpy as np


def class_balanced_val_split(labels: np.ndarray, val_split: float = 0.2):
    """Return (train_idx, val_idx) lists; labels (N,) int or (N, C) multihot."""
    labels = np.asarray(labels)
    n = len(labels)
    if labels.ndim == 1:
        val_indices = []
        for label in np.unique(labels):
            n_samples = math.ceil((labels == label).sum() * val_split)
            val_indices.append(np.where(labels == label)[0][:n_samples])
        val_idx = set(np.concatenate(val_indices).tolist())
        train_idx = sorted(set(range(n)) - val_idx)
        return list(train_idx), sorted(val_idx)

    # multilabel greedy cover (feature.py:150-166)
    lab = labels.copy().astype(np.float64)
    val_target_count = np.ceil(lab.sum(axis=0) * val_split)
    next_targets = np.where(val_target_count > 0)[0]
    val_idx = []
    while next_targets.size > 0:
        target_cls = next_targets[0]
        next_sample = int(np.where(lab[:, target_cls] > 0)[0][0])
        val_idx.append(next_sample)
        val_target_count -= lab[next_sample]
        lab[next_sample] = 0
        next_targets = np.where(val_target_count > 0)[0]
    train_idx = sorted(set(range(n)) - set(val_idx))
    return list(train_idx), val_idx


def sample_few_shot_subset(labels: np.ndarray, num_samples_per_class: int, random_seed: int):
    """Seeded few-shot subset indices (contract of vision_datasets'
    ``sample_few_shot_subset``; reference call site feature.py:591-594).

    Scans images in a seeded random order, keeping an image if any of its
    classes still needs samples; guarantees <= n per class for multiclass and
    >= coverage-greedy behaviour for multilabel.  Returns sorted indices.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(random_seed)
    order = rng.permutation(len(labels))
    if labels.ndim == 1:
        n_classes = int(labels.max()) + 1 if len(labels) else 0
        counts = np.zeros(n_classes, np.int64)
        picked = []
        for i in order:
            c = int(labels[i])
            if counts[c] < num_samples_per_class:
                counts[c] += 1
                picked.append(int(i))
        return sorted(picked)

    n_classes = labels.shape[1]
    counts = np.zeros(n_classes, np.int64)
    picked = []
    for i in order:
        classes = np.where(labels[i] > 0)[0]
        if any(counts[c] < num_samples_per_class for c in classes):
            counts[classes] += 1
            picked.append(int(i))
    return sorted(picked)
