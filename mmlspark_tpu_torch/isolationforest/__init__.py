"""Isolation forest (counterpart of ``mmlspark_tpu/isolationforest/``):
numpy on the host, as in the JAX package."""

from .iforest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
