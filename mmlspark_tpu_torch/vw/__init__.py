"""VW-equivalent module: hashed-feature online linear learning (counterpart
of ``mmlspark_tpu/vw/``).

Parity surface: the reference's ``vw`` module (SURVEY.md §2.4) —
``VowpalWabbitFeaturizer`` (columns → murmur-hashed namespaces),
``VowpalWabbitInteractions`` (namespace crossing),
``VowpalWabbitClassifier``/``VowpalWabbitRegressor`` (online adagrad SGD,
``vw/.../VowpalWabbitBase.scala``), and ``VowpalWabbitContextualBandit``.

Hashing is host work (murmur3 in the port's native loop, bitwise the JAX
package's); the learners keep the padded rows on the estimator's device
(``device=None`` is the CUDA card) and run each minibatch as an eager
gather / scatter-add step there (:mod:`.learners`).
"""

from .featurizer import VowpalWabbitFeaturizer, VowpalWabbitInteractions
from .learners import (VowpalWabbitClassifier, VowpalWabbitClassifierModel,
                       VowpalWabbitRegressor, VowpalWabbitRegressorModel)
from .bandit import (VowpalWabbitContextualBandit,
                     VowpalWabbitContextualBanditModel)

__all__ = [
    "VowpalWabbitFeaturizer", "VowpalWabbitInteractions",
    "VowpalWabbitClassifier", "VowpalWabbitClassifierModel",
    "VowpalWabbitRegressor", "VowpalWabbitRegressorModel",
    "VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel",
]
