"""Hyperparameter search and model selection (counterpart of
``mmlspark_tpu/automl/``)."""

from .hyperparam import (DiscreteHyperParam, GridSpace, HyperparamBuilder,
                         RangeHyperParam, RandomSpace)
from .tune import FindBestModel, FindBestModelResult, TuneHyperparameters

__all__ = [
    "DiscreteHyperParam", "RangeHyperParam", "HyperparamBuilder",
    "GridSpace", "RandomSpace",
    "TuneHyperparameters", "FindBestModel", "FindBestModelResult",
]
