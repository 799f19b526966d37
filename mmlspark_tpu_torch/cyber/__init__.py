"""CyberML: access-anomaly detection on (tenant, user, resource) logs
(counterpart of ``mmlspark_tpu/cyber/``).

Parity surface: the reference's pure-Python ``synapse/ml/cyber`` package
(``core/src/main/python/synapse/ml/cyber/**``):

* feature: per-tenant id indexers and scalers (``feature/indexers.py``,
  ``feature/scalers.py``)
* anomaly: ``ComplementAccessTransformer`` (``anomaly/complement_access.py``)
  and the ``AccessAnomaly`` collaborative-filtering estimator
  (``anomaly/collaborative_filtering.py``)
* ``DataFactory`` demo-data generator (``dataset.py``)

Spark ALS is replaced by alternating least squares on the estimator's
device: per-user/per-item ridge systems built with one matmul and solved
as one batched ``torch.linalg.solve`` per half-step. The rest is host
numpy, copied from the JAX package.
"""

from .features import (IdIndexer, IdIndexerModel, LinearScalarScaler,
                       LinearScalarScalerModel, MultiIndexer,
                       MultiIndexerModel, StandardScalarScaler,
                       StandardScalarScalerModel)
from .complement_access import ComplementAccessTransformer
from .access_anomaly import AccessAnomaly, AccessAnomalyModel
from .dataset import DataFactory

__all__ = [
    "IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel",
    "StandardScalarScaler", "StandardScalarScalerModel",
    "LinearScalarScaler", "LinearScalarScalerModel",
    "ComplementAccessTransformer", "AccessAnomaly", "AccessAnomalyModel",
    "DataFactory",
]
