"""Train wrappers and metrics (counterpart of ``mmlspark_tpu/train/``)."""

from .metrics import (ComputeModelStatistics, ComputePerInstanceStatistics,
                      confusion_matrix, roc_auc)
from .train import (TrainClassifier, TrainedClassifierModel,
                    TrainedRegressorModel, TrainRegressor)

__all__ = [
    "TrainClassifier", "TrainRegressor",
    "TrainedClassifierModel", "TrainedRegressorModel",
    "ComputeModelStatistics", "ComputePerInstanceStatistics",
    "confusion_matrix", "roc_auc",
]
