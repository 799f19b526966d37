"""The core data plane of the port (counterpart of ``mmlspark_tpu/core/``):
DataFrame, params, pipeline stages, persistence and device residency."""

from .dataframe import DataFrame, concat
from .params import (ComplexParam, Param, Params, ParamMap, HasInputCol,
                     HasOutputCol, HasInputCols, HasOutputCols, HasLabelCol,
                     HasFeaturesCol, HasWeightCol, HasPredictionCol,
                     HasProbabilityCol, HasBatchSize, HasErrorCol, HasSeed)
from .pipeline import (Estimator, Model, Pipeline, PipelineModel,
                       PipelineStage, Transformer)

__all__ = [
    "DataFrame", "concat",
    "Param", "ComplexParam", "Params", "ParamMap",
    "HasInputCol", "HasOutputCol", "HasInputCols", "HasOutputCols",
    "HasLabelCol", "HasFeaturesCol", "HasWeightCol", "HasPredictionCol",
    "HasProbabilityCol", "HasBatchSize", "HasErrorCol", "HasSeed",
    "PipelineStage", "Transformer", "Estimator", "Model",
    "Pipeline", "PipelineModel",
]
