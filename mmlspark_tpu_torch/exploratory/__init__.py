"""Data balance measures (counterpart of ``mmlspark_tpu/exploratory/``)."""

from .balance import (AggregateBalanceMeasure, DistributionBalanceMeasure,
                      FeatureBalanceMeasure)

__all__ = ["FeatureBalanceMeasure", "DistributionBalanceMeasure",
           "AggregateBalanceMeasure"]
