from .base import Classifier, Standardizer
from .boosting import AdaBoostClassifier, GradientBoostingClassifier
from .trees import (
    DecisionTreeClassifier,
    ExtraTreesClassifier,
    RandomForestClassifier,
    RegressionTree,
)

__all__ = [
    "Classifier", "Standardizer", "AdaBoostClassifier",
    "GradientBoostingClassifier", "DecisionTreeClassifier",
    "ExtraTreesClassifier", "RandomForestClassifier", "RegressionTree",
]
