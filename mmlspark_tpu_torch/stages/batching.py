"""Prefetch and batch slicing for the batch runner (the part of
``mmlspark_tpu/stages/batching.py`` that ``models/runner.py`` needs:
``PrefetchIterator`` and ``batch_slices``; the minibatch transformers and
streaming batchers are not ported yet).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List

__all__ = ["PrefetchIterator", "batch_slices"]


def batch_slices(n: int, batch_size: int) -> List[slice]:
    return [slice(i, min(i + batch_size, n)) for i in range(0, n, batch_size)]


class _QueueProducer:
    """A daemon thread draining ``it`` into a bounded queue.

    The producer half of the JAX package's streaming batchers (reference
    ``DynamicBufferedBatcher``, Batchers.scala:12-56): items flow into
    ``self.queue`` capped at ``max_buffer_size`` (this bound is what keeps
    host memory finite when the producer outruns the consumer), a sentinel
    marks exhaustion, and a producer-side exception is parked for the
    consumer to re-raise.
    """

    SENTINEL = object()

    def __init__(self, it: Iterable, max_buffer_size: int):
        self.queue: "queue.Queue" = queue.Queue(maxsize=max_buffer_size)
        self._error: List[BaseException] = []

        def produce():
            try:
                for item in it:
                    self.queue.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._error.append(e)
            finally:
                self.queue.put(self.SENTINEL)

        # a producer crash is contained: the BaseException is captured for
        # raise_pending() on the consumer side and the sentinel still lands
        # in finally; a restart would re-iterate the source and duplicate
        # items
        self.thread = threading.Thread(target=produce, daemon=True)
        self.thread.start()

    def raise_pending(self) -> None:
        if self._error:
            raise self._error[0]


class PrefetchIterator:
    """Bounded in-order background prefetch over any iterator.

    ``depth`` items are computed ahead on the producer thread while the
    consumer works on the current one — the host-side half of the device
    pipeline (coerce/pad of batch k+1 overlapping dispatch of batch k), with
    the queue bound capping host memory at ``depth`` prepared batches. Items
    come out one at a time and in order: device feeds must stay aligned
    with their row slices.
    """

    def __init__(self, it: Iterable, depth: int = 2):
        self._producer = _QueueProducer(it, max_buffer_size=max(1, int(depth)))

    def __iter__(self) -> Iterator:
        q = self._producer.queue
        while True:
            item = q.get()
            if item is _QueueProducer.SENTINEL:
                break
            yield item
        self._producer.raise_pending()
