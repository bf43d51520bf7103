"""The 8x8 handwritten digits of the liquid digit pipelines, with NumPy and
the standard library only.

``data/digits.csv.gz`` is the UCI "Optical Recognition of Handwritten
Digits" test set (1797 images of 8x8 pixels in 0..16, E. Alpaydin and
C. Kaynak, 1998) as scikit-learn ships it (BSD-3; ``data/README.md``).
`load_digits` reads it as scikit-learn's ``load_digits`` does, and
`train_test_split` is the stratified split that
``liquid_manifold_digits.main`` takes from scikit-learn
(``StratifiedShuffleSplit`` with its ``_approximate_mode``), its draws from
``np.random.RandomState(random_state)`` in the same order, so one seed
gives the same indices.  ``training_liquid_pipeline`` and
``liquid_manifold_digits`` import these two functions, so they need no
scikit-learn.
"""

from __future__ import annotations

import gzip
import os
from math import floor
from types import SimpleNamespace

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "digits.csv.gz")


def load_digits():
    """``images`` (1797, 8, 8), ``data`` (1797, 64) float64 pixels and
    ``target`` (1797,) int labels, as `sklearn.datasets.load_digits`."""
    with gzip.open(DATA, mode="rt", encoding="utf-8") as f:
        table = np.loadtxt(f, delimiter=",")
    target = table[:, -1].astype(int, copy=False)
    data = table[:, :-1]
    return SimpleNamespace(data=data, target=target,
                           images=data.reshape(-1, 8, 8))


def _approximate_mode(class_counts, n_draws, rng):
    """scikit-learn's ``utils.extmath._approximate_mode``: the draws per
    class, ties of the remainders broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def train_test_split(data, target, train_size, stratify, random_state):
    """``sklearn.model_selection.train_test_split(data, target,
    train_size=..., stratify=..., random_state=...)`` with no
    ``test_size`` (the test set is the rest): returns ``(data_train,
    data_test, target_train, target_test)``."""
    data, target = np.asarray(data), np.asarray(target)
    n = len(data)
    n_train = floor(train_size * n) if isinstance(train_size, float) \
        else int(train_size)
    n_test = n - n_train
    classes, y_indices, class_counts = np.unique(
        np.asarray(stratify), return_inverse=True, return_counts=True)
    if class_counts.min() < 2 or n_train < len(classes) \
            or n_test < len(classes):
        raise ValueError("each class needs 2 members, and each side of the "
                         "split one member of every class")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    train, test = rng.permutation(train), rng.permutation(test)
    return data[train], data[test], target[train], target[test]
