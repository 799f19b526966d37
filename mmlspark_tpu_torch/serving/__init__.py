"""DataFrame-as-microservice: serve a pipeline over HTTP.

Parity surface: the reference's Spark Serving
(``org/apache/spark/sql/execution/streaming/{HTTPSource,DistributedHTTPSource}.scala``
and ``continuous/{HTTPSourceV2,HTTPSinkV2}.scala``):

* per-worker HTTP server with epoch-keyed request queues
  (``HTTPSourceV2.scala:476-697``, queues ``:512-518``)
* reply routing back to the originating connection
  (``HTTPSinkV2.scala:105-148``, ``WorkerServer.replyTo:536-554``)
* failure replay: unanswered requests of an epoch are re-served after a
  worker restart (``registerPartition`` rehydration, ``:489-506,556-568``)
* the ``IOImplicits`` DSL (``io/IOImplicits.scala:20-220``):
  ``parse_request`` / ``make_reply`` here are module functions instead of
  DataFrame extension methods.

Framing: requests buffer on the host and drain as *columnar batches*
into the same minibatch→pad→device path every other stage uses, so a
served model hits the card with large batches instead of row-at-a-time
inference. The multi-worker plane (driver registry, cross-worker reply
routing, forwarding, session failover) is :mod:`.distributed`;
``python -m mmlspark_tpu_torch.serving`` starts a driver or a worker.

The port's copy of ``mmlspark_tpu/serving/__init__.py``.
"""

from .admission import AdmissionQueue, ConsistentHashRing, TenantOverBudget
from .registry import (ModelRegistry, ModelVersion, Resolution,
                       get_registry, reset_registry, set_registry)
from .server import CachedRequest, WorkerServer
from .source import HTTPSource, parse_request, make_reply, HTTPSink
from .engine import ServingEngine
from .continuous import ContinuousDecoder
from .generation import GenerationEngine
from .kv_pool import (AFFINITY_HEADER, KVAutotuner, PagedKVPool,
                      PoolExhausted, affinity_headers)

__all__ = ["CachedRequest", "WorkerServer", "HTTPSource", "HTTPSink",
           "parse_request", "make_reply", "ServingEngine",
           "ContinuousDecoder", "GenerationEngine",
           "PagedKVPool", "KVAutotuner", "PoolExhausted",
           "AFFINITY_HEADER", "affinity_headers",
           "AdmissionQueue", "ConsistentHashRing", "TenantOverBudget",
           "ModelRegistry", "ModelVersion", "Resolution",
           "get_registry", "set_registry", "reset_registry"]
