"""Pipeline stages (counterpart of ``mmlspark_tpu/stages/``): the
utility transformers of ``misc.py`` and the batching helpers."""

from .batching import PrefetchIterator, batch_slices
from .misc import (Cacher, ClassBalancer, ClassBalancerModel, DropColumns,
                   EnsembleByKey, Explode, Lambda, MultiColumnAdapter,
                   PartitionConsolidator, RenameColumn, Repartition,
                   SelectColumns, StratifiedRepartition, SummarizeData,
                   TextPreprocessor, Timer, TimerModel, UDFTransformer,
                   UnicodeNormalize)

__all__ = [
    "PrefetchIterator", "batch_slices",
    "Cacher", "DropColumns", "SelectColumns", "RenameColumn", "Repartition",
    "Explode", "Lambda", "UDFTransformer", "MultiColumnAdapter",
    "ClassBalancer", "ClassBalancerModel", "EnsembleByKey",
    "StratifiedRepartition", "SummarizeData", "TextPreprocessor",
    "UnicodeNormalize", "Timer", "TimerModel", "PartitionConsolidator",
]
