"""Host utilities (the port's copy of ``mmlspark_tpu/utils/``): the
buffered async map, retry/timeout helpers, shared singletons and the
wall-clock ``StopWatch``. The JAX package's device-topology helpers
(``utils/cluster.py``) have no counterpart: the port's ranks get their
devices from :mod:`mmlspark_tpu_torch.parallel`."""

from .async_utils import buffered_await, map_buffered
from .fault import retry_with_backoff, retry_with_timeout
from .shared import SharedSingleton, SharedVariable, StopWatch

__all__ = [
    "buffered_await", "map_buffered",
    "retry_with_timeout", "retry_with_backoff",
    "SharedVariable", "SharedSingleton", "StopWatch",
]
