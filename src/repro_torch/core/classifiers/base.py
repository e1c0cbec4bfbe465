"""Classifier zoo base — pure numpy, no sklearn (not installed here).

All classifiers implement ``fit(X, y) -> self`` and ``predict(X) -> y_hat``
with y in {0, 1} (0 = serial paradigm, 1 = parallel paradigm).  A shared
``Standardizer`` handles feature scaling for the margin/distance-based models.
"""
from __future__ import annotations

import numpy as np


class Standardizer:
    def fit(self, X: np.ndarray) -> "Standardizer":
        self.mean_ = X.mean(axis=0)
        self.std_ = X.std(axis=0)
        self.std_ = np.where(self.std_ == 0, 1.0, self.std_)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean_) / self.std_


class Classifier:
    name: str = "classifier"

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Classifier":
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(X) == y).mean())


def check_Xy(X: np.ndarray, y: np.ndarray):
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.int64)
    if X.ndim != 2 or y.ndim != 1 or len(X) != len(y):
        raise ValueError("bad shapes")
    return X, y
