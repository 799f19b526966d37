"""Histogram GBDT (counterpart of ``models/gbdt/``): ``train`` fits a
:class:`Booster` on the card, its per-level histograms built by the
hand-written kernel K6 (``ops/histogram.py``, one launch a level for all
classes of a multiclass model), its bins by the native loop
(``native/``); the DataFrame estimators (``estimators.py``) fit and
apply it through the pipeline API."""

from .binning import BinMapper
from .booster import Booster
from .estimators import (LightGBMClassificationModel, LightGBMClassifier,
                         LightGBMRanker, LightGBMRankerModel,
                         LightGBMRegressionModel, LightGBMRegressor)
from .train import train

__all__ = ["BinMapper", "Booster", "train", "LightGBMClassifier",
           "LightGBMClassificationModel", "LightGBMRegressor",
           "LightGBMRegressionModel", "LightGBMRanker",
           "LightGBMRankerModel"]
