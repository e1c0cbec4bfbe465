"""kNN, logistic regression, Gaussian naive Bayes, linear SVM — numpy."""
from __future__ import annotations

import numpy as np

from .base import Classifier, Standardizer, check_Xy


class KNNClassifier(Classifier):
    name = "knn"

    def __init__(self, k: int = 7):
        self.k = k

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.std_ = Standardizer().fit(X)
        self.X_ = self.std_.transform(X)
        self.y_ = y
        return self

    def predict(self, X):
        Xq = self.std_.transform(np.asarray(X, dtype=np.float64))
        out = np.empty(len(Xq), dtype=np.int64)
        # chunk queries to bound the distance-matrix memory
        for i0 in range(0, len(Xq), 512):
            q = Xq[i0 : i0 + 512]
            d2 = ((q[:, None, :] - self.X_[None, :, :]) ** 2).sum(-1)
            nn = np.argpartition(d2, self.k, axis=1)[:, : self.k]
            out[i0 : i0 + 512] = (self.y_[nn].mean(axis=1) >= 0.5).astype(np.int64)
        return out


class LogisticRegression(Classifier):
    name = "logistic"

    def __init__(self, lr: float = 0.1, steps: int = 3000, l2: float = 1e-4):
        self.lr = lr
        self.steps = steps
        self.l2 = l2

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.std_ = Standardizer().fit(X)
        Xs = self.std_.transform(X)
        Xs = np.concatenate([Xs, np.ones((len(Xs), 1))], axis=1)
        w = np.zeros(Xs.shape[1])
        m = np.zeros_like(w)
        v = np.zeros_like(w)
        for t in range(1, self.steps + 1):  # Adam
            p = 1.0 / (1.0 + np.exp(-(Xs @ w)))
            g = Xs.T @ (p - y) / len(y) + self.l2 * w
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1 - 0.9**t)
            vh = v / (1 - 0.999**t)
            w -= self.lr * mh / (np.sqrt(vh) + 1e-8)
        self.w_ = w
        return self

    def predict(self, X):
        Xs = self.std_.transform(np.asarray(X, dtype=np.float64))
        Xs = np.concatenate([Xs, np.ones((len(Xs), 1))], axis=1)
        return (Xs @ self.w_ >= 0).astype(np.int64)


class GaussianNB(Classifier):
    name = "naive_bayes"

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.classes_ = np.array([0, 1])
        self.mu_ = np.stack([X[y == c].mean(axis=0) for c in self.classes_])
        self.var_ = np.stack([X[y == c].var(axis=0) + 1e-9 for c in self.classes_])
        self.prior_ = np.array([(y == c).mean() for c in self.classes_])
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        ll = -0.5 * (
            ((X[:, None, :] - self.mu_) ** 2 / self.var_).sum(-1)
            + np.log(self.var_).sum(-1)
        ) + np.log(self.prior_)
        return self.classes_[np.argmax(ll, axis=1)]


class LinearSVM(Classifier):
    name = "linear_svm"

    def __init__(self, lr: float = 0.05, steps: int = 4000, C: float = 1.0,
                 seed: int = 0):
        self.lr = lr
        self.steps = steps
        self.C = C
        self.seed = seed

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        ys = y * 2.0 - 1.0
        self.std_ = Standardizer().fit(X)
        Xs = self.std_.transform(X)
        Xs = np.concatenate([Xs, np.ones((len(Xs), 1))], axis=1)
        rng = np.random.default_rng(self.seed)
        w = np.zeros(Xs.shape[1])
        n = len(ys)
        for t in range(1, self.steps + 1):  # Pegasos-style SGD on hinge loss
            idx = rng.integers(0, n, 256)
            xb, yb = Xs[idx], ys[idx]
            margin = yb * (xb @ w)
            viol = margin < 1
            g = w / (self.C * n) - (yb[viol, None] * xb[viol]).sum(0) / len(idx)
            w -= (self.lr / np.sqrt(t)) * g
        self.w_ = w
        return self

    def predict(self, X):
        Xs = self.std_.transform(np.asarray(X, dtype=np.float64))
        Xs = np.concatenate([Xs, np.ones((len(Xs), 1))], axis=1)
        return (Xs @ self.w_ >= 0).astype(np.int64)
