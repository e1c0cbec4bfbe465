"""Boosting: AdaBoost (the paper's winner) and gradient boosting.

AdaBoost follows SAMME on decision stumps — the classic "Adaptive Boost"
configuration.  The paper reports it as the most accurate of 12 classifiers
(91.69%) and integrates it into the switching system.
"""
from __future__ import annotations

import numpy as np

from .base import Classifier, check_Xy
from .trees import DecisionTreeClassifier, RegressionTree


class AdaBoostClassifier(Classifier):
    name = "adaboost"

    def __init__(self, n_estimators: int = 120, depth: int = 1, seed: int = 0):
        self.n_estimators = n_estimators
        self.depth = depth
        self.seed = seed

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        n = len(y)
        w = np.full(n, 1.0 / n)
        self.stumps_, self.alphas_ = [], []
        for m in range(self.n_estimators):
            stump = DecisionTreeClassifier(
                max_depth=self.depth, min_samples=2, seed=self.seed + m
            )
            stump.fit(X, y, sample_weight=w)
            pred = stump.predict(X)
            err = float(w[pred != y].sum())
            err = min(max(err, 1e-10), 1 - 1e-10)
            alpha = 0.5 * np.log((1 - err) / err)
            if alpha <= 0:
                break
            self.stumps_.append(stump)
            self.alphas_.append(alpha)
            sign = np.where(pred == y, -1.0, 1.0)
            w = w * np.exp(alpha * sign)
            w = w / w.sum()
        if not self.stumps_:  # degenerate: constant majority class
            self._const = int(np.round(y.mean()))
        return self

    def decision_function(self, X):
        if not self.stumps_:
            return np.full(len(X), self._const * 2.0 - 1.0)
        votes = np.zeros(len(X))
        for alpha, stump in zip(self.alphas_, self.stumps_):
            votes += alpha * (stump.predict(X) * 2.0 - 1.0)
        return votes

    def predict(self, X):
        return (self.decision_function(X) >= 0).astype(np.int64)


class GradientBoostingClassifier(Classifier):
    name = "gradient_boost"

    def __init__(self, n_estimators: int = 80, lr: float = 0.2, depth: int = 3):
        self.n_estimators = n_estimators
        self.lr = lr
        self.depth = depth

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        yf = y.astype(np.float64)
        p0 = np.clip(yf.mean(), 1e-6, 1 - 1e-6)
        self.f0_ = np.log(p0 / (1 - p0))
        f = np.full(len(y), self.f0_)
        self.trees_ = []
        for _ in range(self.n_estimators):
            p = 1.0 / (1.0 + np.exp(-f))
            resid = yf - p  # negative gradient of logloss
            tree = RegressionTree(max_depth=self.depth).fit(X, resid)
            self.trees_.append(tree)
            f = f + self.lr * tree.predict(X)
        return self

    def predict(self, X):
        f = np.full(len(X), self.f0_)
        for tree in self.trees_:
            f = f + self.lr * tree.predict(X)
        return (f >= 0).astype(np.int64)
