from .base import Classifier, Standardizer
from .boosting import AdaBoostClassifier, GradientBoostingClassifier
from .mlp import MLPClassifier
from .simple import GaussianNB, KNNClassifier, LinearSVM, LogisticRegression
from .trees import (
    DecisionTreeClassifier,
    ExtraTreesClassifier,
    RandomForestClassifier,
    RegressionTree,
)
from .zoo import ZOO_NAMES, zoo

__all__ = [
    "Classifier", "Standardizer", "AdaBoostClassifier",
    "GradientBoostingClassifier", "MLPClassifier", "GaussianNB",
    "KNNClassifier", "LinearSVM", "LogisticRegression",
    "DecisionTreeClassifier", "ExtraTreesClassifier",
    "RandomForestClassifier", "RegressionTree", "zoo", "ZOO_NAMES",
]
