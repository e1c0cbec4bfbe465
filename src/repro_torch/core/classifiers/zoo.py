"""The 12-classifier zoo of the paper's Fig 4."""
from __future__ import annotations

from typing import Callable, Dict

from .base import Classifier
from .boosting import AdaBoostClassifier, GradientBoostingClassifier
from .mlp import MLPClassifier
from .simple import GaussianNB, KNNClassifier, LinearSVM, LogisticRegression
from .trees import DecisionTreeClassifier, ExtraTreesClassifier, RandomForestClassifier


def zoo(seed: int = 0) -> Dict[str, Callable[[], Classifier]]:
    """Factories for the 12 classifiers compared in Fig 4."""
    return {
        "adaboost": lambda: AdaBoostClassifier(seed=seed),
        "decision_tree": lambda: DecisionTreeClassifier(max_depth=10, seed=seed),
        "random_forest": lambda: RandomForestClassifier(seed=seed),
        "extra_trees": lambda: ExtraTreesClassifier(seed=seed),
        "gradient_boost": lambda: GradientBoostingClassifier(),
        "knn": lambda: KNNClassifier(),
        "logistic": lambda: LogisticRegression(),
        "naive_bayes": lambda: GaussianNB(),
        "linear_svm": lambda: LinearSVM(seed=seed),
        "mlp_8": lambda: MLPClassifier(hidden=8, seed=seed),
        "mlp_16": lambda: MLPClassifier(hidden=16, seed=seed),
        "mlp_32": lambda: MLPClassifier(hidden=32, seed=seed),
    }


ZOO_NAMES = tuple(zoo().keys())
