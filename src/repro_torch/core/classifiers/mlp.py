"""MLP-x classifiers (Fig 4's "MLP x" = x hidden neurons) — numpy + Adam."""
from __future__ import annotations

import numpy as np

from .base import Classifier, Standardizer, check_Xy


class MLPClassifier(Classifier):
    def __init__(self, hidden: int = 16, steps: int = 4000, lr: float = 3e-3,
                 seed: int = 0):
        self.hidden = hidden
        self.steps = steps
        self.lr = lr
        self.seed = seed
        self.name = f"mlp_{hidden}"

    def _forward(self, params, X):
        W1, b1, W2, b2 = params
        h = np.tanh(X @ W1 + b1)
        return h, h @ W2 + b2

    def fit(self, X, y):
        X, y = check_Xy(X, y)
        self.std_ = Standardizer().fit(X)
        Xs = self.std_.transform(X)
        rng = np.random.default_rng(self.seed)
        d = Xs.shape[1]
        W1 = rng.normal(0, 1.0 / np.sqrt(d), (d, self.hidden))
        b1 = np.zeros(self.hidden)
        W2 = rng.normal(0, 1.0 / np.sqrt(self.hidden), (self.hidden, 1))
        b2 = np.zeros(1)
        params = [W1, b1, W2, b2]
        m = [np.zeros_like(p) for p in params]
        v = [np.zeros_like(p) for p in params]
        n = len(y)
        yf = y.astype(np.float64)[:, None]
        for t in range(1, self.steps + 1):
            idx = rng.integers(0, n, min(512, n))
            xb, yb = Xs[idx], yf[idx]
            h, logit = self._forward(params, xb)
            p = 1.0 / (1.0 + np.exp(-logit))
            dlogit = (p - yb) / len(xb)
            gW2 = h.T @ dlogit
            gb2 = dlogit.sum(0)
            dh = dlogit @ params[2].T * (1 - h * h)
            gW1 = xb.T @ dh
            gb1 = dh.sum(0)
            for i, g in enumerate([gW1, gb1, gW2, gb2]):
                m[i] = 0.9 * m[i] + 0.1 * g
                v[i] = 0.999 * v[i] + 0.001 * g * g
                mh = m[i] / (1 - 0.9**t)
                vh = v[i] / (1 - 0.999**t)
                params[i] = params[i] - self.lr * mh / (np.sqrt(vh) + 1e-8)
        self.params_ = params
        return self

    def predict(self, X):
        Xs = self.std_.transform(np.asarray(X, dtype=np.float64))
        _, logit = self._forward(self.params_, Xs)
        return (logit[:, 0] >= 0).astype(np.int64)
