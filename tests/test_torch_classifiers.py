"""The port's 12-classifier zoo (the paper's Fig 4) against the reference's.

``repro_torch.core.classifiers`` keeps NumPy copies of the reference's
classifiers; each member, fitted on the same data from the same seed, must
predict what the reference's predicts, array for array, on
``test_dataset_classifiers.py``'s separable problem and its mini paradigm
dataset.
"""
import numpy as np
import pytest

import repro.core.classifiers as RC
import repro_torch.core.classifiers as PC
from repro.core import generate_dataset

_DATA = {}


def mini_dataset():
    """``test_dataset_classifiers.py``'s 384-layer sub-grid, split 75/25."""
    if "mini" not in _DATA:
        ds = generate_dataset(
            source_grid=(50, 200, 400), target_grid=(100, 300),
            density_grid=(0.1, 0.3, 0.6, 0.9),
            delay_grid=(1, 2, 4, 6, 8, 10, 12, 16), seed=7,
        )
        _DATA["mini"] = ds.split(0.25, seed=0)
    return _DATA["mini"]


def separable():
    """``TestClassifierZoo.test_separable_problem``'s axis-aligned data."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 4))
    y = (X[:, 1] > 0.1).astype(np.int64)
    return (X[:500], y[:500]), (X[500:], y[500:])


def test_zoo_names_and_exports_equal_reference():
    assert PC.ZOO_NAMES == RC.ZOO_NAMES and len(PC.ZOO_NAMES) == 12
    assert list(PC.zoo(seed=3)) == list(RC.zoo(seed=3))
    assert PC.__all__ == RC.__all__
    for name in ("MLPClassifier", "GaussianNB", "KNNClassifier", "LinearSVM",
                 "LogisticRegression", "zoo", "ZOO_NAMES"):
        assert name in PC.__all__


@pytest.mark.parametrize("data", ["separable", "mini"])
@pytest.mark.parametrize("name", RC.ZOO_NAMES)
def test_zoo_member_predicts_as_reference(name, data):
    (Xtr, ytr), (Xte, yte) = separable() if data == "separable" else mini_dataset()
    r, p = RC.zoo(seed=0)[name](), PC.zoo(seed=0)[name]()
    assert type(p).__name__ == type(r).__name__ and p.name == r.name
    r.fit(Xtr, ytr)
    p.fit(Xtr, ytr)
    X = np.concatenate([Xtr, Xte])
    want, got = r.predict(X), p.predict(X)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert p.score(Xte, yte) == r.score(Xte, yte)
    if data == "separable":
        assert p.score(Xte, yte) >= 0.9, name
