"""CART trees (classifier + regressor), random forest, extra-trees.

Vectorized split search: candidate thresholds are midpoints of sorted unique
feature values (capped per node), gini/MSE evaluated with cumulative sums.
"""
from __future__ import annotations

import numpy as np

from .base import Classifier, check_Xy

_MAX_CANDIDATES = 64


def _candidate_thresholds(col: np.ndarray, rng=None, extra: bool = False):
    u = np.unique(col)
    if len(u) < 2:
        return None
    if extra:
        rng = rng or np.random.default_rng()
        return np.array([rng.uniform(u[0], u[-1])])
    mids = (u[1:] + u[:-1]) / 2.0
    if len(mids) > _MAX_CANDIDATES:
        mids = mids[np.linspace(0, len(mids) - 1, _MAX_CANDIDATES).astype(int)]
    return mids


def _gini_split(col, y, w, thresholds):
    """Weighted gini impurity of each threshold split; returns (best_t, score)."""
    left = col[None, :] <= thresholds[:, None]          # (T, N)
    wl = (left * w).sum(axis=1)
    wr = w.sum() - wl
    p1l = (left * (w * y)).sum(axis=1) / np.maximum(wl, 1e-12)
    p1r = ((~left) * (w * y)).sum(axis=1) / np.maximum(wr, 1e-12)
    gini = wl * 2 * p1l * (1 - p1l) + wr * 2 * p1r * (1 - p1r)
    gini = np.where((wl < 1e-12) | (wr < 1e-12), np.inf, gini)
    b = int(np.argmin(gini))
    return thresholds[b], gini[b]


def _mse_split(col, y, thresholds):
    left = col[None, :] <= thresholds[:, None]
    nl = left.sum(axis=1)
    nr = len(y) - nl
    sl = (left * y).sum(axis=1)
    sr = y.sum() - sl
    ssl = (left * y**2).sum(axis=1)
    ssr = (y**2).sum() - ssl
    sse = (ssl - sl**2 / np.maximum(nl, 1)) + (ssr - sr**2 / np.maximum(nr, 1))
    sse = np.where((nl == 0) | (nr == 0), np.inf, sse)
    b = int(np.argmin(sse))
    return thresholds[b], sse[b]


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = value


class DecisionTreeClassifier(Classifier):
    name = "decision_tree"

    def __init__(self, max_depth: int = 10, min_samples: int = 4,
                 max_features: int | None = None, extra: bool = False,
                 seed: int = 0):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.max_features = max_features
        self.extra = extra
        self.seed = seed

    def fit(self, X, y, sample_weight=None):
        X, y = check_Xy(X, y)
        w = (np.ones(len(y)) if sample_weight is None
             else np.asarray(sample_weight, dtype=np.float64))
        w = w / w.sum()
        self.rng_ = np.random.default_rng(self.seed)
        self.root_ = self._build(X, y, w, 0)
        return self

    def _leaf_value(self, y, w):
        p1 = (w * y).sum() / max(w.sum(), 1e-12)
        return p1

    def _build(self, X, y, w, depth):
        node = _Node(self._leaf_value(y, w))
        if (depth >= self.max_depth or len(y) < self.min_samples
                or len(np.unique(y)) < 2):
            return node
        n_feat = X.shape[1]
        feats = np.arange(n_feat)
        if self.max_features and self.max_features < n_feat:
            feats = self.rng_.choice(n_feat, self.max_features, replace=False)
        best = (np.inf, -1, 0.0)
        for f in feats:
            th = _candidate_thresholds(X[:, f], self.rng_, self.extra)
            if th is None:
                continue
            t, score = _gini_split(X[:, f], y, w, th)
            if score < best[0]:
                best = (score, f, t)
        if best[1] < 0:
            return node
        f, t = best[1], best[2]
        mask = X[:, f] <= t
        if mask.all() or (~mask).all():
            return node
        node.feature, node.threshold = f, t
        node.left = self._build(X[mask], y[mask], w[mask], depth + 1)
        node.right = self._build(X[~mask], y[~mask], w[~mask], depth + 1)
        return node

    def predict_proba(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X))
        # iterative traversal per-sample (trees are shallow; N is small)
        for i, x in enumerate(X):
            node = self.root_
            while node.feature >= 0:
                node = node.left if x[node.feature] <= node.threshold else node.right
            out[i] = node.value
        return out

    def predict(self, X):
        return (self.predict_proba(X) >= 0.5).astype(np.int64)


class RegressionTree:
    """MSE regression tree (for gradient boosting)."""

    def __init__(self, max_depth: int = 3, min_samples: int = 8):
        self.max_depth = max_depth
        self.min_samples = min_samples

    def fit(self, X, y):
        self.root_ = self._build(np.asarray(X, float), np.asarray(y, float), 0)
        return self

    def _build(self, X, y, depth):
        node = _Node(float(y.mean()) if len(y) else 0.0)
        if depth >= self.max_depth or len(y) < self.min_samples:
            return node
        best = (np.inf, -1, 0.0)
        for f in range(X.shape[1]):
            th = _candidate_thresholds(X[:, f])
            if th is None:
                continue
            t, score = _mse_split(X[:, f], y, th)
            if score < best[0]:
                best = (score, f, t)
        if best[1] < 0:
            return node
        f, t = best[1], best[2]
        mask = X[:, f] <= t
        if mask.all() or (~mask).all():
            return node
        node.feature, node.threshold = f, t
        node.left = self._build(X[mask], y[mask], depth + 1)
        node.right = self._build(X[~mask], y[~mask], depth + 1)
        return node

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X))
        for i, x in enumerate(X):
            node = self.root_
            while node.feature >= 0:
                node = node.left if x[node.feature] <= node.threshold else node.right
            out[i] = node.value
        return out


class RandomForestClassifier(Classifier):
    name = "random_forest"

    def __init__(self, n_trees: int = 40, max_depth: int = 12, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.seed = seed

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        rng = np.random.default_rng(self.seed)
        self.trees_ = []
        for t in range(self.n_trees):
            idx = rng.integers(0, len(y), len(y))
            tree = DecisionTreeClassifier(
                max_depth=self.max_depth, max_features=2,
                seed=self.seed + 1000 + t,
            )
            tree.fit(X[idx], y[idx])
            self.trees_.append(tree)
        return self

    def predict(self, X):
        p = np.mean([t.predict_proba(X) for t in self.trees_], axis=0)
        return (p >= 0.5).astype(np.int64)


class ExtraTreesClassifier(RandomForestClassifier):
    name = "extra_trees"

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.trees_ = []
        for t in range(self.n_trees):
            tree = DecisionTreeClassifier(
                max_depth=self.max_depth, max_features=2, extra=True,
                seed=self.seed + 2000 + t,
            )
            tree.fit(X, y)
            self.trees_.append(tree)
        return self
