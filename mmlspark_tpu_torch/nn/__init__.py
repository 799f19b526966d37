"""Exact nearest neighbours (counterpart of ``mmlspark_tpu/nn/``): the
brute-force ``KNN`` on the card and the host ball tree of
``ConditionalKNN``."""

from .balltree import BallTree
from .knn import (KNN, ConditionalKNN, ConditionalKNNModel, KNNModel,
                  brute_force_knn)

__all__ = ["BallTree", "KNN", "KNNModel", "ConditionalKNN",
           "ConditionalKNNModel", "brute_force_knn"]
