"""Bounded-concurrency future draining.

Parity surface: ``AsyncUtils.bufferedAwait`` (``core/.../core/utils/AsyncUtils.scala``)
used by the async HTTP client (``io/http/Clients.scala:48-62``): keep at most
``concurrency`` requests in flight while yielding results in input order.

The port's copy of ``mmlspark_tpu/utils/async_utils.py`` (host threads
only).
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")
R = TypeVar("R")

__all__ = ["buffered_await", "map_buffered"]


def buffered_await(futures: Iterable["concurrent.futures.Future[R]"],
                   concurrency: int,
                   timeout_s: Optional[float] = None) -> Iterator[R]:
    """Yield results in order, never materializing more than ``concurrency``
    outstanding futures. Caller supplies an iterator that *lazily* submits."""
    buf: collections.deque = collections.deque()
    it = iter(futures)
    try:
        for _ in range(max(1, concurrency)):
            buf.append(next(it))
    except StopIteration:
        pass
    while buf:
        fut = buf.popleft()
        # await before pulling the next future: pulling first would let the
        # caller submit while `fut` still runs — concurrency+1 in flight
        result = fut.result(timeout=timeout_s)
        try:
            buf.append(next(it))
        except StopIteration:
            pass
        yield result


def map_buffered(fn: Callable[[T], R], items: Iterable[T], concurrency: int,
                 timeout_s: Optional[float] = None) -> Iterator[R]:
    """Apply ``fn`` with bounded parallelism, yielding in input order."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, concurrency)) as ex:
        yield from buffered_await((ex.submit(fn, x) for x in items),
                                  concurrency, timeout_s)
