"""Recommendation (counterpart of ``mmlspark_tpu/recommendation/``): SAR's
two products on the card, the ranking stages on the host."""

from .ranking import (RankingAdapter, RankingAdapterModel, RankingEvaluator,
                      RankingTrainValidationSplit, RecommendationIndexer,
                      RecommendationIndexerModel)
from .sar import SAR, SARModel

__all__ = [
    "SAR", "SARModel",
    "RecommendationIndexer", "RecommendationIndexerModel",
    "RankingEvaluator", "RankingAdapter", "RankingAdapterModel",
    "RankingTrainValidationSplit",
]
